"""The chain DP's share of its roofline over the traced passes: the
least time of the work the reference counts (``benchmark/roofline.py``)
over the profiler's device time of the chain DP's kernels (the run
finder and the walk), in percent."""

from benchmark import roofline, trace


def read(rec):
    if rec.trace is None:
        return None
    seconds = trace.chain_seconds(rec.trace)
    if seconds <= 0:
        return None
    work = roofline.pass_work(rec.reference, rec.device_plan, rec.config["window"])
    if work["evals"] == 0:
        return None
    least, binds = roofline.least_time(work, rec.config["hpc"])
    rec.notes.append(
        f"chain DP roofline: {work['evals']} evaluations, {work['anchors']} anchors, {work['runs']} runs, "
        f"{work['rows']} rows a pass; least {least:.6e} s a pass ({binds} bind) x {rec.traced_passes} passes "
        f"against {seconds:.6e} s of kernels; card {rec.card}"
    )
    return 100.0 * least * rec.traced_passes / seconds
