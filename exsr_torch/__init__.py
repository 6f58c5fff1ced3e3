"""PyTorch/CUDA port of ``exsr`` (explorable super resolution).

The package runs the CEM-wrapped explorable RRDB generator on an NVIDIA
Hopper GPU: serving, the Z-edit engine, batch evaluation and SR
training; and explorable JPEG decoding (the DCT codec, the JFIF reader,
the DnCNN generator, ``JPEGEditSession`` and the ``eval_jpeg`` CLI);
JPEG training and KernelGAN; and the exploration server
(``exsr_torch.apps.web``) with the tools that feed it checkpoints
(``exsr_torch.apps.scripts``).  It imports ``torch``, numpy and scipy
only; the JAX package ``exsr`` beside it is the numeric reference its
tests hold it to.

Public functions take and return NHWC tensors, as ``exsr`` does.  Entry
points run on CUDA unless the caller passes ``device='cpu'``
(:func:`exsr_torch.device.resolve_device`).
"""
