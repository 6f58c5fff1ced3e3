"""The whole iteration's share of the chip's fp32 peak, %: the model
operations of one dual D step and one dual G step, counted from the
shapes (``benchmark.drivers.train.iteration_flops``), over the mean
untraced iteration of the traced run on the host clock (from the top of
the loop to the synchronize that ends it, as ``train_iter_ms`` counts an
iteration) and 67 TFLOP/s."""


def read(ctx):
    ms = ctx.get('iter_ms')
    if not ms:
        return None
    c = ctx['counts']
    return 100.0 * c['model_flops'] / (sum(ms) / len(ms) / 1e3) / \
        c['peak_flops']
