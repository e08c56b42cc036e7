"""Faults planted under the timed path, to show that ``correct`` catches
them: each is a context manager that patches the code under test while it
is active (training), or a wrapper around the served function (serving)."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _wrapped_train_step(wrap):
    from sota_imagenet_tpu_torch.train import steps as steps_mod

    real = steps_mod.build_train_step

    def build(*a, **kw):
        return wrap(real(*a, **kw))

    steps_mod.build_train_step = build
    try:
        yield
    finally:
        steps_mod.build_train_step = real


def unchanged_state():
    """A step that returns its state unchanged: it runs, then every
    parameter and buffer is put back as it was."""
    import torch

    def wrap(step):
        def broken(state, batch):
            before = [t.detach().clone() for t in state.model.state_dict().values()]
            state, metrics = step(state, batch)
            with torch.no_grad():
                for t, b in zip(state.model.state_dict().values(), before):
                    t.copy_(b)
            return state, metrics

        return broken

    return _wrapped_train_step(wrap)


def half_batch():
    """Half of the batch left out: the step sees the first half of the rows
    and takes its mean over them."""

    def wrap(step):
        def broken(state, batch):
            n = batch["image"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})

        return broken

    return _wrapped_train_step(wrap)


def altered_answer(serve):
    """One logit of the first row of every answer moved by ten times the row's spread."""

    def broken(images):
        out = serve(images).clone()
        out[0, 0] += 10.0 * out[0].float().std()
        return out

    return broken


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
SERVE = {"altered_answer": altered_answer}
