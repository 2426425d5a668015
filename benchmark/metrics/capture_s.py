"""Seconds the engine's super-batch programs took to capture their CUDA
graphs (the sum of each program's ``capture_s`` after ``warmup``)."""


def read(rec):
    return rec.spans["capture_s"]
