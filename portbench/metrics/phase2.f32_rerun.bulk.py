"""phase2.f32_rerun.bulk: % of the quantized phase-2 dispatches whose
certificate failed and reran over f32 storage
(quantized.rescore{result=fallback} over all quantized.rescore)."""


def read(ctx):
    reg = ctx.registry
    if reg is None:
        return None
    c = reg["counters"]
    fb = c.get("quantized.rescore{result=fallback}", 0)
    total = fb + c.get("quantized.rescore{result=exact}", 0)
    return 100.0 * fb / total if total else None
