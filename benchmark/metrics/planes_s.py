"""Seconds of the ``DeviceOverlapEngine`` construction, where the index
planes are built on the card, synchronised: the harness's span."""


def read(rec):
    return rec.spans["planes_s"]
