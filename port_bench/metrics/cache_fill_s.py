"""Seconds the device cache took to fill (``DeviceCacheFeed.fill_s``)."""


def read(s):
    return s.get("cache_fill_s")
