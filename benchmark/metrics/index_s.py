"""Seconds of ``lrge_tpu_torch.ops.index.build_index`` over the
targets, the harness's span around the call."""


def read(rec):
    return rec.spans["index_s"]
