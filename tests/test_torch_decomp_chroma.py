"""The port's chroma trainer against exsr's, on the CPU, at a tiny setup
(DnCNN nf 16, depth 3, patch 64, batch 2; the frozen Y generator with 8
latent channels).

Both start from exsr's seeded weights and take exsr's draws (the
Bernoulli mix of real and generated Y, the penalty's alpha), made from the
keys its ``_step`` splits.  exsr's optimizers store the step's gradients
in their state; the port's G gradients are taken against exsr's updated
critic, as exsr's G step sees it.  Tolerances as in
``tests/test_torch_decomp.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from exsr.models.dncnn import DnCNN as JDnCNN, DnCNNConfig as JGConfig, \
    DnCNNDiscriminator as JDisc
from exsr.train.decomp import DecompConfig as JConfig
from exsr.train.decomp_chroma import ChromaDecompTrainer as JTrainer, \
    regroup_y_coeffs_16 as j_regroup
from exsr.train.srragan import flax_d_adapter
from exsr_torch.models.convert import (dncnn_d_from_exsr_vars,
                                       dncnn_from_exsr_vars)
from exsr_torch.models.dncnn import DnCNN, DnCNNConfig, DnCNNDiscriminator
from exsr_torch.train.decomp import DecompConfig
from exsr_torch.train.decomp_chroma import (ChromaDecompTrainer,
                                            regroup_y_coeffs_16)

B, PATCH, NF, DEPTH, YLAT = 2, 64, 16, 3, 8
GRAD_TOL, METRIC_RTOL, STATS_TOL = 1e-4, 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _capture():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _mixed_key():
    """A state key whose Bernoulli draw mixes real and generated Y."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        mix = jax.random.bernoulli(jax.random.split(key, 3)[1], 0.5, (B,))
        if 0 < int(mix.sum()) < B:
            return key
    raise AssertionError('no mixed draw')


@pytest.fixture(scope='module')
def setup():
    return build()


def build(rules=None) -> dict:
    """Both trainers on exsr's seeded weights, exsr's step (its batch
    sharded by ``rules`` when given) and its draws."""
    jcfg = JConfig(latent_channels=0, chroma_mode=True)
    hb16 = PATCH // 16
    gy_cfg = dict(n_channels=NF, depth=DEPTH, num_latent_channels=YLAT)
    gc_cfg = dict(n_channels=NF, depth=DEPTH, in_nc=256 + 128, out_nc=128,
                  num_latent_channels=0, chroma_generator=True, block_size=8)
    jgy, jgc = JDnCNN(JGConfig(**gy_cfg)), JDnCNN(JGConfig(**gc_cfg))
    jd = JDisc(n_channels=NF, depth=DEPTH, expected_input_size=hb16,
               norm='layer')
    gy_vars = jgy.init(jax.random.PRNGKey(7), jnp.zeros((1, 8, 8, 64)),
                       jnp.zeros((1, 8, 8, YLAT)))
    packed0 = jnp.zeros((1, hb16, hb16, 256 + 128))
    gc_vars = dict(jgc.init(jax.random.PRNGKey(0), packed0, None))
    d_vars = dict(jd.init(jax.random.PRNGKey(1), packed0))

    def gy_apply(coeffs, _z):
        z = jnp.zeros(coeffs.shape[:3] + (YLAT,))
        return jgy.apply(gy_vars, coeffs, z, train=False,
                         mutable=['batch_stats'])[0]

    def gc_apply(params, packed, _z):
        return jgc.apply(params, packed, None, train=True,
                         mutable=['batch_stats'])[0]

    def gc_stats_apply(params, packed, _z):
        out, mut = jgc.apply(params, packed, None, train=True,
                             mutable=['batch_stats'])
        return out, mut['batch_stats']

    jtr = JTrainer(jcfg, gy_apply, gc_apply, flax_d_adapter(jd),
                   g_stats_apply=gc_stats_apply, rules=rules)
    jtr.g_tx = jtr.d_tx = _capture()
    jstate = jtr.init_state(gc_vars, d_vars, _mixed_key())

    gy = DnCNN(DnCNNConfig(**gy_cfg))
    gy.load_state_dict(dncnn_from_exsr_vars(_np(dict(gy_vars))))
    gc = DnCNN(DnCNNConfig(**gc_cfg))
    gc.load_state_dict(dncnn_from_exsr_vars(_np(gc_vars)))
    d = DnCNNDiscriminator(n_channels=NF, depth=DEPTH,
                           expected_input_size=hb16, norm='layer',
                           in_nc=256 + 128)
    d.load_state_dict(dncnn_d_from_exsr_vars(_np(d_vars)))
    tr = ChromaDecompTrainer(DecompConfig(**jcfg.__dict__), gy)
    state = tr.init_state(gc, d, 0, 'cpu')

    rng = np.random.default_rng(0)
    uncomp = (255 * rng.uniform(size=(B, PATCH, PATCH, 3))).astype(
        np.float32)
    qf = np.array([10, 30], np.int32)
    jbatch = {'uncomp': jnp.asarray(uncomp), 'qf': jnp.asarray(qf)}
    batch = {'uncomp': torch.from_numpy(uncomp), 'qf': torch.from_numpy(qf)}
    _, mix_rng, gp_rng = jax.random.split(jstate.rng, 3)
    draws = {'is_fake': torch.from_numpy(np.array(
                 jax.random.bernoulli(mix_rng, 0.5, (B,)))),
             'alpha': torch.from_numpy(np.array(
                 jax.random.uniform(gp_rng, (B, 1, 1, 1))))}
    # (the sharded step donates its state: draw first)
    jnew, jm = jtr.step_fn(
        jstate, jbatch if rules is None else rules.shard_batch(jbatch),
        use_gan=True)
    return dict(jtr=jtr, jstate=jstate, jnew=jnew, jm=jm, tr=tr,
                state=state, batch=batch, jbatch=jbatch, draws=draws,
                gy_kw=gy_cfg, gc_kw=gc_cfg, gy_state=gy.state_dict(),
                d_kw=dict(n_channels=NF, depth=DEPTH,
                          expected_input_size=hb16, norm='layer',
                          in_nc=256 + 128))


def _close_grads(named: dict, ref: dict) -> float:
    assert named.keys() == ref.keys()
    scale = max(float(v.abs().max()) for v in ref.values())
    return max(float((named[k] - ref[k]).abs().max()) for k in ref) / scale


def test_regroup_y_coeffs_16_bit_equal():
    x = np.random.default_rng(0).normal(size=(2, 6, 4, 64)).astype(
        np.float32)
    np.testing.assert_array_equal(
        regroup_y_coeffs_16(torch.from_numpy(x)).numpy(),
        np.asarray(j_regroup(jnp.asarray(x))))


def test_inputs_match_exsr(setup):
    """The mixed Y and the packed generator input and reference chroma."""
    s = setup
    jtr, tr = s['jtr'], s['tr']
    qf = s['batch']['qf'].float()
    y = s['batch']['uncomp'][..., :1]
    mixed = tr.fake_y(y, qf, s['draws']['is_fake'])
    jmixed, _ = jtr._fake_y(s['jbatch']['uncomp'][..., :1],
                            s['jbatch']['qf'].astype(jnp.float32),
                            jax.random.split(s['jstate'].rng, 3)[1],
                            mix=True)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(jmixed), atol=1e-3)
    prep = tr.prepare(s['batch'], s['draws'])
    jpacked, _, jref = jtr._chroma_inputs(
        s['jbatch']['uncomp'], jmixed, s['jbatch']['qf'].astype(jnp.float32))
    np.testing.assert_array_equal(prep['packed'][..., 256:].numpy(),
                                  np.asarray(jpacked)[..., 256:])
    np.testing.assert_allclose(prep['packed'].numpy(), np.asarray(jpacked),
                               atol=1e-4)
    np.testing.assert_allclose(prep['ref_chroma'].numpy(), np.asarray(jref),
                               atol=1e-4)


def test_step_gradients_metrics_and_statistics_match_exsr(setup):
    """The D gradients, then the G gradients against exsr's updated D,
    the metrics, and the chroma generator's running statistics."""
    s = setup
    tr, state, jnew = s['tr'], s['state'], s['jnew']
    prep = tr.prepare(s['batch'], s['draws'])
    d_grads, d_metrics = tr.d_grads(state, prep, s['draws'])
    names = [n for n, _ in state.d.named_parameters()]
    ref = dncnn_d_from_exsr_vars({'params': _np(jnew.d_opt)})
    assert _close_grads(dict(zip(names, d_grads)), ref) < GRAD_TOL
    state.d.load_state_dict(dncnn_d_from_exsr_vars(
        {'params': _np(jnew.d_vars['params'])}))
    g_grads, g_metrics = tr.g_grads(state, prep, use_gan=True)
    names = [n for n, _ in state.g.named_parameters()]
    ref = {k: v for k, v in dncnn_from_exsr_vars(
        {'params': _np(jnew.gc_opt['params'])}).items() if k in names}
    assert _close_grads(dict(zip(names, g_grads)), ref) < GRAD_TOL
    metrics = {**d_metrics, **g_metrics}
    assert metrics.keys() == s['jm'].keys()
    for k, v in s['jm'].items():
        np.testing.assert_allclose(float(metrics[k]), float(v),
                                   rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
    want = {k: v for k, v in dncnn_from_exsr_vars(_np(jnew.gc_params))
            .items() if 'running' in k}
    sd = state.g.state_dict()
    assert max(float((sd[k] - v).abs().max())
               for k, v in want.items()) < STATS_TOL


def test_step_moves_d_then_g_and_decodes(setup):
    """One step through the trainer's own draws: both nets move, the step
    advances, the metrics are finite and the CbCr decode has its shape."""
    s = setup
    tr = s['tr']
    gc = DnCNN(s['state'].g.cfg)
    gc.load_state_dict(s['state'].g.state_dict())
    d = DnCNNDiscriminator(n_channels=NF, depth=DEPTH,
                           expected_input_size=PATCH // 16, norm='layer',
                           in_nc=256 + 128)
    state = tr.init_state(gc, d, 3, 'cpu')
    g0 = [p.detach().clone() for p in state.g.parameters()]
    d0 = [p.detach().clone() for p in state.d.parameters()]
    state, metrics = tr.step(state, s['batch'])
    assert state.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(not torch.equal(a, b) for a, b in
               zip(state.g.parameters(), g0))
    # (the WGAN loss gives the head's bias no gradient)
    assert any(not torch.equal(a, b) for a, b in
               zip(state.d.parameters(), d0))
    qf = s['batch']['qf'].float()
    packed, _ = tr.chroma_inputs(
        s['batch']['uncomp'],
        tr.fake_y(s['batch']['uncomp'][..., :1], qf), qf)
    assert tr.decode(state.g, packed, qf).shape == (B, PATCH, PATCH, 2)
