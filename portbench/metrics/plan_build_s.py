"""``plan_build_s``: ``LocalityPlan.build`` in set-up (ordering, the
train-row subgraph, the split, the admission probe when it runs); host
clock around the call."""


def read(run):
    return run.setup_spans.get("plan_build_s")
