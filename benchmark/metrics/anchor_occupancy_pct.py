"""Anchors chained over anchor slots of the device's buffers
(``last_anchors_valid`` / ``last_anchor_slots``), summed over the
window's passes, in percent."""


def read(rec):
    slots = sum(p.anchor_slots for p in rec.passes)
    return 100.0 * sum(p.anchors_valid for p in rec.passes) / slots if slots else None
