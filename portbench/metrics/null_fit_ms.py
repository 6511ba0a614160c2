"""null_fit_ms: the host's clock around each trait's ``fit_null`` (its
result is on the host, so the call has synchronised), summed over the
untraced window and divided by the traits: one reading spans many calls,
and none pays the profiler's cost per launch."""


def read(run):
    calls = run.spans.get("fit_null", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
