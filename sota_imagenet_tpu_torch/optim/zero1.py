"""ZeRO-1: the optimizer state sharded over the ranks (port of ``mesh.zero1``,
``sota_imagenet_tpu/parallel/mesh.py``:106-141 and ``cli.py``:285-290).

Each rank of the data axis (``parallel/mesh.py``; the same within each
spatial and model index) owns whole parameters, dealt out by size (largest first, each to
the rank that owns the fewest elements so far), keeps the optimizer state of
its own and steps only them; each rank then broadcasts its updated
parameters, so every rank holds the same weights. The JAX package shards
each state leaf along its largest divisible axis instead: a layout that
differs, with the same numbers. The optimizers of the port step each
parameter by elementwise and per-parameter operations, so a sharded step
equals the replicated one bit for bit; Adai's and AdaiS' means over every
parameter are summed over the shards (``ZooOptimizer.cross_shard``), in
another order than one process sums them.

The checkpoint format is the unsharded optimizer's: ``state_dict`` gathers
every rank's state under the indices the optimizer over all parameters
would give them, and ``load_state_dict`` takes such a dict and keeps this
rank's share, so a run of any rank count, or one process without ZeRO-1,
resumes it. The layout of the unsharded optimizer (its groups, their
hyperparameters and its parameter order) comes from building it over
``meta`` copies of the parameters, which allocate nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch

from sota_imagenet_tpu_torch.optim.zoo import ZooOptimizer
from sota_imagenet_tpu_torch.parallel import mesh as par

Named = List[Tuple[str, torch.nn.Parameter]]


class CrossShard:
    """What a shard's optimizer needs of the others for a mean over every
    parameter: the sum over the ranks, and the totals of all shards."""

    def __init__(self, params: int, elements: int):
        self.params, self.elements = params, elements

    @staticmethod
    def sum(t: torch.Tensor) -> torch.Tensor:
        return par.all_reduce_(t.clone(), "optimizer")


def deal(sizes: List[int], ranks: int) -> List[int]:
    """The owner of each parameter: largest first, each to the least loaded
    rank (the lowest such rank on a tie). The same on every rank."""
    load, owner = [0] * ranks, [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        r = min(range(ranks), key=lambda r: load[r])
        owner[i] = r
        load[r] += sizes[i]
    return owner


def _inner_optimizers(opt) -> Iterable[torch.optim.Optimizer]:
    """``opt`` and the optimizers it wraps (Lookahead's ``inner``)."""
    while opt is not None:
        yield opt
        opt = getattr(opt, "inner", None)


def _remap(sd: dict, index: Dict[int, int]) -> dict:
    """An optimizer state dict's ``state`` (and a wrapped optimizer's, under
    ``inner``) under new parameter indices; entries not in ``index`` are dropped."""
    out = {"state": {index[i]: st for i, st in sd["state"].items() if i in index}}
    if isinstance(sd.get("inner"), dict):
        out["inner"] = _remap(sd["inner"], index)
    return out


def _fill(dst: dict, src: dict) -> None:
    """Merge ``src``'s states into ``dst`` (both as ``_remap`` returns them)."""
    dst["state"].update(src["state"])
    if "inner" in src:
        _fill(dst.setdefault("inner", {"state": {}}), src["inner"])


def _to_cpu(sd: dict) -> dict:
    return {
        "state": {i: {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in st.items()}
                  for i, st in sd["state"].items()},
        **({"inner": _to_cpu(sd["inner"])} if "inner" in sd else {}),
    }


class Zero1(torch.optim.Optimizer):
    """A ZeRO-1 optimizer over ``named_params``: ``build(named)`` builds the
    port's optimizer over a list of (name, parameter), as ``build_optimizer``
    does. ``param_groups`` are those of the optimizer over all parameters,
    holding the real parameters (the train step sets the lr on them and
    reads the gradients of every parameter from them); ``inner`` is this
    rank's optimizer over its own parameters."""

    def __init__(self, build: Callable[[Named], torch.optim.Optimizer], named_params: Iterable):
        named = list(named_params)
        meta = [(n, torch.empty_like(p, device="meta")) for n, p in named]
        full = build(meta)
        position = {id(m): i for i, (_, m) in enumerate(meta)}
        # the unsharded optimizer's order: a parameter's index in its state dict
        order = [position[id(m)] for g in full.param_groups for m in g["params"]]
        groups = [{**{k: v for k, v in g.items() if k != "params"}, "params": [named[position[id(m)]][1] for m in g["params"]]}
                  for g in full.param_groups]
        super().__init__(groups, dict(full.defaults))
        del full, meta
        world, rank = par.data_count(), par.data_index()
        owner = deal([named[i][1].numel() for i in order], world)
        if len(set(owner)) < world:
            raise ValueError(f"ZeRO-1 over {world} ranks needs at least {world} parameters, got {len(named)}")
        own_named = [named[order[c]] for c, r in enumerate(owner) if r == rank]
        self.inner = build(own_named)
        for opt in _inner_optimizers(self.inner):
            if isinstance(opt, ZooOptimizer):
                opt.cross_shard = CrossShard(len(named), sum(p.numel() for _, p in named))
        params = [p for g in self.param_groups for p in g["params"]]
        self._canonical = {id(p): c for c, p in enumerate(params)}
        # what each rank broadcasts after its step: its parameters, one flat buffer per dtype
        self._broadcasts = []
        for src in range(world):
            by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
            for c in (c for c, r in enumerate(owner) if r == src):
                by_dtype.setdefault(params[c].dtype, []).append(params[c])
            self._broadcasts += [(src, ps) for ps in by_dtype.values()]
        # the wrapper's group of each inner group's parameters (for the lr)
        group_of = {id(p): j for j, g in enumerate(self.param_groups) for p in g["params"]}
        self._group_of_inner = [group_of[id(g["params"][0])] for g in self.inner.param_groups]

    def _shard_index(self) -> Dict[int, int]:
        """This rank's optimizer's parameter index -> the unsharded one."""
        own = [p for g in self.inner.param_groups for p in g["params"]]
        return {i: self._canonical[id(p)] for i, p in enumerate(own)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Zero1.step takes no closure")
        for g, j in zip(self.inner.param_groups, self._group_of_inner):
            g["lr"] = self.param_groups[j]["lr"]
        self.inner.step()
        with torch._C.DisableTorchFunction():  # whole tensors, whatever mode marks the step's reductions
            for src, ps in self._broadcasts:
                flat = par.broadcast_(par.flatten(ps), src, "params")
                if src != par.data_index():
                    par.unflatten_(ps, flat)
        return None

    def state_dict(self) -> dict:
        """The unsharded optimizer's state dict, gathered from every rank (on the CPU)."""
        sd = super().state_dict()  # the groups under the unsharded indices, no state
        mine = _to_cpu(_remap(self.inner.state_dict(), self._shard_index()))
        merged = {"state": {}}
        for src in range(par.data_count()):
            _fill(merged, par.broadcast_object(mine, src, axis="data"))
        sd["state"] = dict(sorted(merged["state"].items()))
        if "inner" in merged:
            sd["inner"] = {"state": dict(sorted(merged["inner"]["state"].items())), "param_groups": sd["param_groups"]}
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Keep this rank's share of an unsharded optimizer's state dict; the
        groups' hyperparameters stay this run's."""
        back = {c: i for i, c in self._shard_index().items()}
        shard = _remap(state_dict, back)
        own = self.inner.state_dict()

        def with_groups(sd, like):
            out = {"state": sd["state"], "param_groups": like["param_groups"]}
            if "inner" in sd:
                out["inner"] = with_groups(sd["inner"], like["inner"])
            return out

        self.inner.load_state_dict(with_groups(shard, own))
