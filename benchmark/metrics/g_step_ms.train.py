"""Device ms of one dual G step: CUDA events around the public
``g_step`` call, mean over the untraced iterations of the traced run."""


def read(ctx):
    ms = ctx.get('g_step_ms')
    return sum(ms) / len(ms) if ms else None
