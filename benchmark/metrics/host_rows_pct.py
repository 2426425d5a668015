"""The share of query rows recounted on the host (``BatchCounts.
fallback_rows``) over every pass of the window, in percent."""


def read(rec):
    return 100.0 * sum(p.fallback_rows for p in rec.passes) / (rec.n_queries * len(rec.passes))
