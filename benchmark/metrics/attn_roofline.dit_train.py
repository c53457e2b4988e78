"""% of its roofline the attention kernel reaches in a DiT-XL train step: the
least time of the forward calls the traced window launched over the
`flash_attention` family's time. Each launch of the family is one call of
the configuration's `attention_calls` (one shape, at the cell's batch), so
the forwards a step runs (two under `remat`: the step's and the backward's
recompute) are counted from the trace, not taken from the configuration."""
from benchmark.harness.families import family
from benchmark.harness.peaks import forward_attention_bound_s


def read(view):
    s = view.family_s("flash_attention")
    launches = sum(1 for _, _, n in view.device_ops
                   if family(n) == "flash_attention")
    if not view.steps or not s or not launches:
        return None
    per_forward = sum(row[3] for row in view.config["attention_calls"])
    bound = (forward_attention_bound_s(view.config, view.batch)
             * launches / per_forward)
    return 100.0 * bound / s
