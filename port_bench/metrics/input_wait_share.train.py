"""Share of the traced window's wall time in which the train loop's host
waited for its next batch (the Runner's ``data_time_s`` over its
``epoch_time_s``), in %."""


def read(s):
    if not s.get("epoch_time_s") or s.get("data_time_s") is None:
        return None
    return 100.0 * s["data_time_s"] / s["epoch_time_s"]
