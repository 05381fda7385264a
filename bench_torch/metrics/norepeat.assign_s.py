"""Mean seconds a render of the no-repeat assignment
(`RenderOutcome.info["assign_s"]`: the native engine and its refills)."""


def read(run):
    xs = [r.info["assign_s"] for r in run.records if r.info and "assign_s" in r.info]
    return sum(xs) / len(xs) if xs else None
