"""Device ms of one dual D step: CUDA events around the public
``d_step`` call, mean over the untraced iterations of the traced run."""


def read(ctx):
    ms = ctx.get('d_step_ms')
    return sum(ms) / len(ms) if ms else None
