"""Device time a render of K10's stripe entry (`csrc/l1_topcap.cu`
`l1_stripe_kernel`), in ms: the exact distances behind the no-repeat
assignment's device refills and the adaptive scorer's fallback rows.
Its launches' shapes are not reported, so no roofline share is taken."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.per_render(r"\bl1_stripe_kernel\b")
    return None if s is None else 1e3 * s
