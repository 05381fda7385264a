"""Mean seconds a render of the no-repeat scoring route
(`RenderOutcome.info["scoring_s"]`, `render/norepeat.py`)."""


def read(run):
    xs = [r.info["scoring_s"] for r in run.records if r.info and "scoring_s" in r.info]
    return sum(xs) / len(xs) if xs else None
