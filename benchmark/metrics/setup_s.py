"""From the process's start to the first timed pass: interpreter and
imports, the corpus, the index, the planes, the warm-up with its graph
captures, and one untimed pass."""


def read(rec):
    return rec.setup_s
