"""leaderboard_s.pass: host seconds of `compute_pseudo_labels` (the top-K
leaderboard) per pass, from the benchmark's span around the call."""


def read(trace):
    spans = trace.facts.get("leaderboard_s")
    return sum(spans) / len(spans) if spans else None
