"""Every fp32 entry point of the port turns TF32 off itself, forward and
backward, and restores the caller's flags after.

PyTorch's default runs cuDNN's fp32 convolutions in TF32 (a 10-bit
mantissa), which is not what exsr computes.  Each test sets both TF32 flags
on, calls an entry point on the CPU, and reads both flags at every
convolution and matrix product that runs inside the call, forward and
backward: a dispatch mode sees the convolutions of modules and of plain
``F.conv2d`` calls alike, and the backward's; a function mode sees the
calls made under ``torch.inference_mode``, which the dispatch mode does
not.  The flags are global, so what they read on the CPU is what cuDNN
would read on the card."""
import numpy as np
import pytest
import torch
from PIL import Image
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from exsr_torch.device import full_fp32

aten = torch.ops.aten
CONVS = {aten.convolution.default, aten.convolution_backward.default}
PRODUCTS = {aten.mm.default, aten.bmm.default, aten.addmm.default}
FUNCTIONS = {torch.nn.functional.conv2d: 'convolution',
             torch.nn.functional.conv_transpose2d: 'convolution',
             torch.matmul: 'mm', torch.Tensor.__matmul__: 'mm'}


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


class _Ops(TorchDispatchMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in CONVS or func in PRODUCTS:
            self.seen.setdefault(func.overloadpacket.__name__,
                                 set()).add(_flags())
        return func(*args, **(kwargs or {}))


class _Functions(TorchFunctionMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in FUNCTIONS:
            self.seen.setdefault(FUNCTIONS[func], set()).add(_flags())
        return func(*args, **(kwargs or {}))


class FlagRecorder:
    """The two TF32 flags at each convolution and matrix product."""

    def __init__(self):
        self.seen = {}
        self._modes = (_Functions(self.seen), _Ops(self.seen))

    def __enter__(self):
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in self._modes[::-1]:
            m.__exit__(*exc)


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _recorded(call, backward=False):
    rec = FlagRecorder()
    with rec:
        call()
    assert torch.backends.cudnn.allow_tf32, 'cuDNN flag not restored'
    assert torch.backends.cuda.matmul.allow_tf32, 'matmul flag not restored'
    assert 'convolution' in rec.seen
    if backward:
        assert 'convolution_backward' in rec.seen
    flags = set().union(*rec.seen.values())
    assert flags == {(False, False)}, rec.seen
    return rec.seen


def test_helper_restores_the_flags_after_an_error(tf32_on):
    with pytest.raises(KeyError):
        with full_fp32():
            assert not torch.backends.cudnn.allow_tf32
            raise KeyError
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_build_model_forward(tf32_on):
    from exsr_torch.apps.eval_sr import build_model
    _, fwd = build_model(4, nb=1, nf=16, device='cpu')
    lr = torch.rand(1, 12, 12, 3)
    _recorded(lambda: fwd(lr, torch.zeros(1, 48, 48, 3)))


@pytest.mark.parametrize('fast_trunk', [True, False])
def test_edit_session_forward_and_backward(tf32_on, fast_trunk):
    from exsr_torch.apps.session import EditSession
    s = EditSession(scale=4, nb=1, nf=16, device='cpu',
                    fast_trunk=fast_trunk)
    s.init_random_params(0)
    img = np.random.default_rng(0).uniform(size=(48, 48, 3)) \
        .astype(np.float32)
    _recorded(lambda: s.open_image(img))
    _recorded(s.recompute)
    _recorded(lambda: s.optimize('l1', data={'desired': s.sr},
                                 max_iters=2), backward=True)


@pytest.fixture
def jpeg_session():
    from exsr_torch.apps.jpeg_session import JPEGEditSession
    s = JPEGEditSession(nf=8, nb=3, latent_channels=64, device='cpu')
    s.init_random_params(0)
    return s


def test_jpeg_session_entry_points(tf32_on, jpeg_session):
    from exsr_torch.models.dncnn import DnCNN, DnCNNConfig
    s = jpeg_session
    img = np.random.default_rng(1).uniform(size=(32, 32, 3)) \
        .astype(np.float32)
    seen = _recorded(lambda: s.open_image(img))
    assert 'bmm' in seen or 'mm' in seen     # the DCT's products
    _recorded(s.recompute)
    _recorded(lambda: s.set_uniform_z3([0.2, 0.1, -0.3]))
    _recorded(lambda: s.optimize('max_STD', max_iters=2), backward=True)
    _recorded(lambda: s.optimize('random_VGG', n_alternatives=2,
                                 max_iters=2), backward=True)
    _recorded(lambda: s.alternative_out(0))
    s.attach_chroma(DnCNN(DnCNNConfig(
        n_channels=8, depth=2, in_nc=384, out_nc=128, chroma_generator=True,
        block_size=8, num_latent_channels=0)), nf=8, nb=2)
    _recorded(s.compose_rgb)
    des = np.full((24, 24), 200.0, np.float32)
    mask = np.ones((24, 24), np.float32)
    rec = FlagRecorder()
    with rec:
        s.find_optimal_imprint_mask(des, mask, [4, 4, 16, 16], (8, 8),
                                    (8, 8))
    assert set().union(*rec.seen.values()) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32


def test_eval_jpeg_main(tf32_on, tmp_path):
    from exsr_torch.apps import eval_jpeg
    (tmp_path / 'imgs').mkdir()
    Image.fromarray((np.random.default_rng(2).uniform(size=(24, 24, 3))
                     * 255).astype(np.uint8)).save(tmp_path / 'imgs' / 'a.png')
    base = ['--data_dir', str(tmp_path / 'imgs'), '--nf', '8', '--nb', '3',
            '--device', 'cpu', '--out_dir', str(tmp_path / 'out')]
    _recorded(lambda: eval_jpeg.main(base + ['--num_z', '2']))
    _recorded(lambda: eval_jpeg.main(base + ['--latent', 'desired_im',
                                             '--num_z_iters', '2']),
              backward=True)


def test_train_sr_steps(tf32_on, tmp_path):
    from exsr_torch.apps import train_sr
    (tmp_path / 'hr').mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        Image.fromarray((rng.uniform(size=(128, 128, 3)) * 255)
                        .astype(np.uint8)).save(tmp_path / 'hr' / f'{i}.png')
    _recorded(lambda: train_sr.main([
        '--hr_dir', str(tmp_path / 'hr'), '--exp_dir', str(tmp_path / 'exp'),
        '--niter', '1', '--scale', '4', '--patch', '112', '--batch', '2',
        '--nb', '1', '--nf', '8', '--gc', '4', '--d_nb', '4', '--d_nf', '8',
        '--d_strides', '1', '--device', 'cpu']), backward=True)


def _jpeg_batch(channels, seed):
    rng = np.random.default_rng(seed)
    return {'uncomp': torch.from_numpy((255 * rng.uniform(
                size=(2, 32, 32, channels))).astype(np.float32)),
            'qf': torch.tensor([10, 40], dtype=torch.int32)}


@pytest.mark.parametrize('dual', [False, True])
def test_decomp_steps(tf32_on, dual):
    from exsr_torch.models.dncnn import (DnCNN, DnCNNConfig,
                                         DnCNNDiscriminator)
    from exsr_torch.train.decomp import DecompConfig, DecompTrainer
    tr = DecompTrainer(DecompConfig(optimal_z_iters=2))
    state = tr.init_state(
        DnCNN(DnCNNConfig(n_channels=8, depth=3, num_latent_channels=64)),
        DnCNNDiscriminator(n_channels=8, depth=3, expected_input_size=4),
        0, 'cpu')
    batch = _jpeg_batch(1, 4)
    _recorded(lambda: tr.d_step(state, batch, dual=dual), backward=True)
    _recorded(lambda: tr.g_step(state, batch, dual=dual), backward=True)


def test_chroma_step(tf32_on):
    from exsr_torch.models.dncnn import (DnCNN, DnCNNConfig,
                                         DnCNNDiscriminator)
    from exsr_torch.train.decomp import DecompConfig
    from exsr_torch.train.decomp_chroma import ChromaDecompTrainer
    tr = ChromaDecompTrainer(
        DecompConfig(latent_channels=0, chroma_mode=True),
        DnCNN(DnCNNConfig(n_channels=8, depth=3, num_latent_channels=8)))
    state = tr.init_state(
        DnCNN(DnCNNConfig(n_channels=8, depth=3, in_nc=384, out_nc=128,
                          chroma_generator=True, block_size=8,
                          num_latent_channels=0)),
        DnCNNDiscriminator(n_channels=8, depth=3, expected_input_size=2,
                           in_nc=384), 0, 'cpu')
    _recorded(lambda: tr.step(state, _jpeg_batch(3, 5)), backward=True)


def test_train_jpeg_main(tf32_on, tmp_path):
    from exsr_torch.apps import train_jpeg
    (tmp_path / 'imgs').mkdir()
    Image.fromarray((np.random.default_rng(6).uniform(size=(32, 32, 3))
                     * 255).astype(np.uint8)).save(tmp_path / 'imgs' / 'a.png')
    base = ['--data_dir', str(tmp_path / 'imgs'), '--val_dir',
            str(tmp_path / 'imgs'), '--val_freq', '1', '--patch', '32',
            '--batch', '1', '--nf', '8', '--nb', '3', '--niter', '1',
            '--device', 'cpu']
    _recorded(lambda: train_jpeg.main(
        base + ['--exp_dir', str(tmp_path / 'y')]), backward=True)
    _recorded(lambda: train_jpeg.main(
        base + ['--exp_dir', str(tmp_path / 'c'), '--chroma']),
        backward=True)


def test_kernelgan_estimate(tf32_on):
    from exsr_torch.kernelgan.kernelgan import KernelGAN, KernelGANConfig
    kg = KernelGAN(KernelGANConfig(max_iters=2, g_chan=8, d_chan=8,
                                   d_n_layers=3), device='cpu')
    img = np.random.default_rng(7).uniform(size=(72, 72, 3)) \
        .astype(np.float32)
    seen = _recorded(lambda: kg.estimate(img), backward=True)
    assert 'mm' in seen       # the kernel's centre of mass
