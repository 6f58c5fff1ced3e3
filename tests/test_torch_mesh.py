"""The port's spatial mesh axis (``exsr_torch.parallel.{mesh,halo,spatial}``)
on gloo ranks on the CPU, against ``exsr``'s sharded computation on the
8-device virtual mesh: the rank grid and its shards, the height-sharded
CEM ``enforce``, the CEM-wrapped generator forward and its gradients, the
Z-less ``MSRResNet`` and ``SRResNet`` forwards against one process, the
halo exchange's adjoint (halos wider than a shard included), and the
errors.

Two launches of four ranks (a 1 x 4 and a 2 x 2 grid) run once for the
module, beside ``exsr``'s side in this process; the ranks read their
inputs from ``.npy`` files and write their results for the tests to
compare.  The ranks import this module, which imports JAX only inside
the parent's functions.
"""
import concurrent.futures
import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

SF, MARGINS = 4, 10
NF, GC, NB, NZ = 8, 4, 1, 3
E_LR, G_LR, BATCH = 32, 16, 2
GRIDS = {'1x4': (1, 4), '2x2': (2, 2)}
HALO_HEIGHTS, HALO_TOP, HALO_BOTTOM = (3, 1, 4, 2), 5, 6
# the sharded port against the one-process port: the same arithmetic on
# every pixel, so at most a few fp32 rounding steps of the largest element
# apart where a library kernel sums in another order
FP32_STEPS = 4 * 2.0 ** -23


def _inputs(d):
    rng = np.random.default_rng(0)
    arrays = {
        'e_lr': rng.uniform(size=(BATCH, E_LR, E_LR, 3)),
        'e_gen': rng.uniform(size=(BATCH, SF * E_LR, SF * E_LR, 3)),
        'lr': rng.uniform(size=(BATCH, G_LR, G_LR, 3)),
        'z': rng.uniform(-1, 1, size=(BATCH, SF * G_LR, SF * G_LR, NZ)),
        'w': rng.normal(size=(BATCH, SF * G_LR, SF * G_LR, 3))}
    for k, v in arrays.items():
        np.save(f'{d}/{k}.npy', v.astype(np.float32))
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _load(d, *names):
    return [torch.from_numpy(np.load(f'{d}/{k}.npy')) for k in names]


def _params_tree(seed=1):
    """``exsr``'s RRDBNet parameter tree, drawn with numpy (He-scaled
    weights, small biases) instead of flax's initialiser."""
    import jax
    import jax.numpy as jnp
    from exsr.models.rrdb import RRDBNet
    g = RRDBNet(nb=NB, nf=NF, gc=GC, latent_channels=NZ)
    shapes = jax.eval_shape(g.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, G_LR, G_LR, 3)),
                            jnp.zeros((1, SF * G_LR, SF * G_LR, NZ)))
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) >= 4:
            fan_in = int(np.prod(s.shape[-4:-1]))
            return (rng.normal(size=s.shape) * np.sqrt(1.0 / fan_in)) \
                .astype(np.float32)
        return (0.05 * rng.normal(size=s.shape)).astype(np.float32)
    return g, jax.tree.map(draw, shapes)


def _state(tree):
    from exsr_torch.models.convert import from_exsr_params
    return from_exsr_params(tree)


# ------------------------------------------------------------------ ranks
def _rank(init, rank, world, tmp, grid, d):
    import torch.distributed as dist
    from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
    from exsr_torch.models.rrdb import RRDBNet
    from exsr_torch.models.rrdb_fast import (pack_grouped_params,
                                             rrdbnet_apply_fast)
    from exsr_torch.parallel import spatial
    from exsr_torch.parallel.halo import halo_exchange
    from exsr_torch.parallel.mesh import ShardingRules, make_mesh
    torch.set_num_threads(1)  # one a rank; ranks share a worker
    dist.init_process_group('gloo', init_method=init, rank=rank,
                            world_size=world)
    data, sp = GRIDS[grid]
    res = {}
    for bad in ((3, 1), (None, 3)):
        try:
            make_mesh(*bad, device='cpu')
        except ValueError as e:
            res[f'error{bad}'] = str(e)
    mesh = make_mesh(data, sp, device='cpu')
    rules = ShardingRules(mesh)
    res['grid'] = (mesh.data_index, mesh.spatial_index)
    probe = {'x': np.zeros((4, 8, 5, 3)), 'qf': np.zeros(4), 's': 1.0}
    res['specs'] = {k: [(s.start, s.stop) for s in rules.batch_spec(v)]
                    for k, v in probe.items()}
    # rank 0's values everywhere; shards gathered back in global order; a
    # sum over the rank's data column
    res['replicated'] = rules.replicate({'t': torch.full((3,), rank + 1.0)})
    res['gathered'] = [rules.gather(x) for x in rules.shard_batch(
        [torch.arange(4.0), torch.arange(4 * 8 * 2.0).reshape(4, 8, 2, 1)])]
    res['column_sum'] = float(mesh.dp.all_sum(torch.tensor(rank + 1.0)))
    filt = CEM.create(CEMConf(scale_factor=SF)).device_filters(
        3, device='cpu')

    e_lr, e_gen = rules.shard_batch(_load(d, 'e_lr', 'e_gen'))
    rows = spatial.Rows.equal(mesh, e_lr.shape[1])
    res['enforce'] = rules.gather(spatial.enforce(filt, e_lr, e_gen, rows))
    # the unfused path with 2-D filters (a non-separable kernel's), against
    # one process at the ranks' thread count
    filt_2d = dataclasses.replace(filt, w_down_1d=None, w_up_1d=None,
                                  w_inv_hth_1d=None)
    res['enforce_2d'] = rules.gather(spatial.enforce(filt_2d, e_lr, e_gen,
                                                     rows))
    res['enforce_2d_one'] = filt_2d.enforce(*_load(d, 'e_lr', 'e_gen'))

    sd = torch.load(f'{d}/state.pt')
    lr, z, w = rules.shard_batch(_load(d, 'lr', 'z', 'w'))

    def grouped(dtype):
        return spatial.cem_wrap(
            lambda p, x, zz, r: spatial.rrdbnet_apply_fast(
                None, x, zz, r, packed=p, dtype=dtype),
            filt, SF)

    for dtype, tag in ((None, 'fp32'), (torch.bfloat16, 'bf16')):
        packed = pack_grouped_params(sd, dtype=dtype)
        leaves = _leaves(packed)
        for t in leaves.values():
            t.requires_grad_()
        zz = z.clone().requires_grad_()
        out = grouped(dtype)(packed, lr, zz, MARGINS, True, mesh)
        (out * w).sum().backward()
        grads = {}
        for k, t in leaves.items():
            if t.grad is not None:
                dist.all_reduce(t.grad)
                grads[k] = t.grad
        res[tag] = {'out': rules.gather(out.detach()),
                    'z_grad': rules.gather(zz.grad), 'grads': grads}
    with torch.no_grad():
        net = RRDBNet(nf=NF, nb=NB, gc=GC, latent_channels=NZ,
                      fused_trunk=True)
        net.load_state_dict(sd)
        res['fused'] = rules.gather(spatial.cem_wrap(
            spatial.rrdbnet_fused, filt, SF)(net, lr, z, MARGINS, True,
                                            mesh))

        # x3: nearest upsampling and a conv in the tail, against one
        # process at the ranks' thread count
        filt3 = CEM.create(CEMConf(scale_factor=3)).device_filters(
            3, device='cpu')
        net3 = RRDBNet(nf=NF, nb=NB, gc=GC, upscale=3, latent_channels=NZ,
                       seed=5)
        x3, z3 = lr[:, :, :12], z[:, :3 * lr.shape[1], :36]
        full3 = rules.gather(x3), rules.gather(z3)
        for fused in (False, True):
            net3.fused_trunk = fused
            g3 = spatial.rrdbnet_fused if fused else (
                lambda p, a, b, r: spatial.rrdbnet_apply_fast(
                    p, a, b, r, upscale=3, dtype=None))
            g1 = (lambda p, a, b: p(a, b)) if fused else (
                lambda p, a, b: rrdbnet_apply_fast(p, a, b, upscale=3,
                                                   dtype=None))
            res[f'x3_{fused}'] = (
                rules.gather(spatial.cem_wrap(g3, filt3, 3)(
                    net3, x3, z3, MARGINS, True, mesh)),
                cem_wrap(g1, filt3, 3)(net3, *full3, MARGINS, True))

        if data == 1:
            res['plain'] = _plain_generators(mesh, rules, lr)

    if data == 1:
        # the adjoint: <halo(x), v> == <x, halo^T(v)>, summed over ranks,
        # on unequal shards whose halos reach past their neighbours
        gen = torch.Generator().manual_seed(rank)
        h = HALO_HEIGHTS[mesh.spatial_index]
        x = torch.randn(2, h, 3, 2, generator=gen, dtype=torch.float64)
        x.requires_grad_()
        y = halo_exchange(x, HALO_TOP, HALO_BOTTOM, mesh, HALO_HEIGHTS)
        v = torch.randn(y.shape, generator=gen, dtype=torch.float64)
        (xg,) = torch.autograd.grad(y, x, v)
        dots = torch.stack([(y * v).sum(), (x * xg).sum()]).detach()
        dist.all_reduce(dots)
        res['halo'] = {'x': x.detach(), 'y': y.detach(), 'dots': dots}
    torch.save(res, f'{tmp}/r{rank}.pt')
    dist.destroy_process_group()


def _plain_generators(mesh, rules, lr) -> dict:
    """The Z-less ``PLAIN_ARCHS`` generators, CEM-wrapped with pre-padding
    at x4 and x3, sharded and in one process (at the ranks' thread
    count): ``{(arch, sf): (sharded, one)}``."""
    from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
    from exsr_torch.models.classifiers import MSRResNet, SRResNet
    from exsr_torch.parallel import spatial
    out = {}
    for sf in (4, 3):
        filt = CEM.create(CEMConf(scale_factor=sf)).device_filters(
            3, device='cpu')
        for cls in (MSRResNet, SRResNet):
            net = cls(nf=NF, nb=2, upscale=sf, seed=3)
            out[cls.__name__, sf] = (
                rules.gather(spatial.cem_wrap(spatial.rrdbnet_module, filt,
                                              sf)(net, lr, None, MARGINS,
                                                  True, mesh)),
                cem_wrap(lambda p, a, b: p(a), filt, sf)(
                    net, rules.gather(lr), None, MARGINS, pre_pad=True))
    return out


def _leaves(packed) -> dict:
    """The packed grouped weights by path."""
    trunk, rest = packed
    out = {f'trunk.{i}.{r}.{k}': v for i, b in enumerate(trunk)
           for r, e in b.items() for k, v in e.items()}
    out.update({f'{n}.{k}': v for n, e in rest.items()
                for k, v in e.items()})
    return out


# ----------------------------------------------------------------- parent
def _exsr_side(x, tree):
    """``exsr``'s sharded jit of each grid: enforce, and the CEM-wrapped
    generator's output with its gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from exsr.cem.cem import CEM, CEMConf, cem_wrap
    from exsr.parallel.mesh import ShardingRules, make_mesh
    g, _ = _params_tree()
    filt = CEM.create(CEMConf(scale_factor=SF)).device_filters(3)
    wrapped = cem_wrap(lambda p, a, b: g.apply(p, a, b), filt, SF)

    def loss(p, a, b, c):
        out = wrapped(p, a, b, MARGINS, pre_pad=True)
        return (out * c).sum(), out

    refs = {}
    for name, (data, sp) in GRIDS.items():
        mesh = make_mesh(data=data, spatial=sp,
                         devices=jax.devices()[:data * sp])
        spec = NamedSharding(mesh, P('data', 'spatial', None, None))
        rep = NamedSharding(mesh, P())
        enf = jax.jit(filt.enforce, in_shardings=(spec, spec),
                      out_shardings=spec)(x['e_lr'], x['e_gen'])
        (_, out), (gp, gz) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 2), has_aux=True),
            in_shardings=(rep, spec, spec, spec))(tree, x['lr'], x['z'],
                                                  x['w'])
        refs[name] = {'enforce': np.asarray(enf), 'out': np.asarray(out),
                      'z_grad': np.asarray(gz),
                      'grads': jax.tree.map(np.asarray, gp)}
        if name == '2x2':
            rules = ShardingRules(mesh)
            sh = rules.shard_batch({'x': np.zeros((4, 8, 5, 3)),
                                    'qf': np.zeros(4)})
            ids = [dv.id for dv in jax.devices()[:4]]
            refs['layout'] = {
                'grid': mesh.devices.shape,
                'devices': [[ids.index(dv.id) for dv in row]
                            for row in mesh.devices],
                'specs': {k: {ids.index(s.device.id):
                              [(i.start or 0, i.stop or v.shape[j])
                               for j, i in enumerate(s.index)
                               if j < (2 if v.ndim == 4 else 1)]
                              for s in v.addressable_shards}
                          for k, v in sh.items()}}
    return refs


def _port_side(x, sd):
    """The port in one process: enforce, and the CEM-wrapped generator's
    fp32 output, its bf16 output and gradients and its fused forward."""
    from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap
    from exsr_torch.models.rrdb import RRDBNet
    from exsr_torch.models.rrdb_fast import (pack_grouped_params,
                                             rrdbnet_apply_fast)
    filt = CEM.create(CEMConf(scale_factor=SF)).device_filters(
        3, device='cpu')
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    res = {'enforce': filt.enforce(t['e_lr'], t['e_gen'])}
    with torch.no_grad():
        res['fp32'] = cem_wrap(lambda p, a, b: rrdbnet_apply_fast(
            p, a, b, dtype=None), filt, SF)(sd, t['lr'], t['z'], MARGINS,
                                            pre_pad=True)
    packed = pack_grouped_params(sd, dtype=torch.bfloat16)
    leaves = _leaves(packed)
    for v in leaves.values():
        v.requires_grad_()
    z = t['z'].clone().requires_grad_()
    out = cem_wrap(lambda p, a, b: rrdbnet_apply_fast(
        None, a, b, packed=p, dtype=torch.bfloat16), filt, SF)(
        packed, t['lr'], z, MARGINS, pre_pad=True)
    (out * t['w']).sum().backward()
    res['bf16'] = {'out': out.detach(), 'z_grad': z.grad,
                   'grads': {k: v.grad for k, v in leaves.items()
                             if v.grad is not None}}
    net = RRDBNet(nf=NF, nb=NB, gc=GC, latent_channels=NZ,
                  fused_trunk=True)
    net.load_state_dict(sd)
    with torch.no_grad():
        res['fused'] = cem_wrap(lambda _, a, b: net(a, b), filt, SF)(
            None, t['lr'], t['z'], MARGINS, pre_pad=True)
    return res


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp('mesh')
    x = _inputs(d)
    _, tree = _params_tree()
    sd = _state(tree)
    torch.save(sd, f'{d}/state.pt')
    dirs = {name: d / name for name in GRIDS}
    with concurrent.futures.ThreadPoolExecutor(len(GRIDS)) as ex:
        futs = []
        for name, sub in dirs.items():
            os.makedirs(sub)
            futs.append(ex.submit(run_ranks, 'test_torch_mesh', '_rank',
                                  sub, 4, 120, (name, str(d))))
        refs = _exsr_side(x, tree)
        port = _port_side(x, sd)
        for f in futs:
            f.result()
    ranks = {name: [torch.load(sub / f'r{r}.pt') for r in range(4)]
             for name, sub in dirs.items()}
    return {'x': x, 'sd': sd, 'refs': refs, 'port': port, 'ranks': ranks}


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def test_grid_and_shards_match_exsr_layout(runs):
    lay = runs['refs']['layout']
    got = runs['ranks']['2x2']
    assert lay['grid'] == (2, 2)
    for r, res in enumerate(got):
        # exsr's device r sits at the same (data, spatial) place as rank r
        assert lay['devices'][res['grid'][0]][res['grid'][1]] == r
        for k in ('x', 'qf'):
            assert res['specs'][k] == lay['specs'][k][r], (k, r)
        assert res['specs']['s'] == []
        assert torch.equal(res['replicated']['t'], torch.ones(3))
        assert torch.equal(res['gathered'][0], torch.arange(4.0))
        assert torch.equal(res['gathered'][1],
                           torch.arange(4 * 8 * 2.0).reshape(4, 8, 2, 1))
        # the data column of rank r holds ranks r % 2 and r % 2 + 2
        assert res['column_sum'] == 2 * (r % 2) + 4


@pytest.mark.parametrize('grid', list(GRIDS))
def test_enforce_matches_exsr_sharded(runs, grid):
    got = runs['ranks'][grid][0]['enforce']
    assert tuple(got.shape) == (BATCH, SF * E_LR, SF * E_LR, 3)
    assert _gap(got, runs['refs'][grid]['enforce']) < 2e-5
    one = runs['port']['enforce']
    assert _gap(got, one) <= FP32_STEPS * float(one.abs().max())
    for res in runs['ranks'][grid][1:]:
        assert torch.equal(res['enforce'], got)
    res = runs['ranks'][grid][0]
    one = res['enforce_2d_one']
    assert _gap(res['enforce_2d'], one) <= FP32_STEPS * float(
        one.abs().max())


@pytest.mark.parametrize('grid', list(GRIDS))
def test_generator_forward_matches_exsr_sharded(runs, grid):
    ref = runs['refs'][grid]['out']
    got = runs['ranks'][grid][0]['fp32']['out']
    assert tuple(got.shape) == ref.shape == (BATCH, SF * G_LR, SF * G_LR, 3)
    assert _gap(got, ref) < 1e-5 * np.abs(ref).max()
    one = runs['port']['fp32']
    assert _gap(got, one) <= FP32_STEPS * float(one.abs().max())


def _packed_ref_grads(jax_grads, sd, port_grads):
    """``exsr``'s parameter gradients in the packed layout, and the port's
    upconv gradients taken back from the folded kernel to the 3 x 3 one
    (the fold maps 9 taps to 16, so it is the port's side that moves)."""
    from exsr_torch.models.rrdb_fast import (fold_upconv_kernel,
                                             pack_grouped_params)
    ref = _leaves(pack_grouped_params(_state(jax_grads)))
    got = dict(port_grads)
    for i in range(2):
        k = sd[f'upconv{i}.weight'].clone().requires_grad_()
        wt = fold_upconv_kernel(k.permute(2, 3, 1, 0)).flip(0, 1) \
            .permute(2, 3, 0, 1)
        (got[f'upconv{i}.weight'],) = torch.autograd.grad(
            wt, k, got.pop(f'upconv{i}.wt'))
    return ref, got


@pytest.mark.parametrize('grid', list(GRIDS))
def test_generator_gradients_match_exsr_sharded(runs, grid):
    ref = runs['refs'][grid]
    got = runs['ranks'][grid][0]['fp32']
    assert _gap(got['z_grad'], ref['z_grad']) < \
        1e-5 * np.abs(ref['z_grad']).max()
    want, have = _packed_ref_grads(ref['grads'], runs['sd'], got['grads'])
    assert set(have) <= set(want)
    assert len(have) == 8 + 2 * 2 + 3 * 10 * NB
    top = max(float(np.abs(want[k].numpy()).max()) for k in have)
    worst = max(_gap(have[k], want[k]) for k in have)
    assert worst < 1e-5 * top


def test_bf16_gradients_match_one_process(runs):
    """The bf16 trunk's forward and gradients, sharded against one
    process.  The forward does the same bf16 arithmetic on every pixel.
    The gradients are bf16 sums grouped otherwise: a halo row's gradient
    reaches its owner after each use, a parameter's is summed over the
    ranks; each sum rounds at bf16's spacing (2**-8 to 2**-7 of a value),
    so they are held to four such steps of their largest element."""
    one = runs['port']['bf16']
    bf16_step = 2.0 ** -8
    for grid in GRIDS:
        got = runs['ranks'][grid][0]['bf16']
        assert _gap(got['out'], one['out']) < \
            1e-6 * float(one['out'].abs().max())
        assert _gap(got['z_grad'], one['z_grad']) < \
            4 * bf16_step * float(one['z_grad'].abs().max())
        assert set(got['grads']) == set(one['grads'])
        top = max(float(g.float().abs().max())
                  for g in one['grads'].values())
        worst = max(_gap(g.float(), one['grads'][k].float())
                    for k, g in got['grads'].items())
        assert worst < 4 * bf16_step * top


def test_fused_trunk_matches_one_process(runs):
    """The fused trunk's sharded forward matches its one-process
    forward."""
    for grid in GRIDS:
        got, one = runs['ranks'][grid][0]['fused'], runs['port']['fused']
        assert _gap(got, one) <= FP32_STEPS * float(one.abs().max())


def test_x3_generators_match_one_process(runs):
    """x3 (nearest upsampling and a conv in the tail; 11-tap CEM
    filters), grouped and fused, against one process."""
    for grid in GRIDS:
        res = runs['ranks'][grid][0]
        for fused in (False, True):
            got, one = res[f'x3_{fused}']
            assert tuple(got.shape) == (BATCH, 48, 36, 3)
            assert _gap(got, one) <= FP32_STEPS * float(one.abs().max())


@pytest.mark.parametrize('arch', ['MSRResNet', 'SRResNet'])
@pytest.mark.parametrize('sf', [4, 3])
def test_plain_generators_match_one_process(runs, arch, sf):
    """``MSRResNet`` (pixel shuffle, the bilinear skip on a one-row halo)
    and ``SRResNet`` (nearest upsampling) on 1 x 4 shards of 4 LR rows,
    pre-padded by the margins, against one process.

    At x3 the resize's scale 1/3 is no float: each HR row's source
    position is off by up to its index times the scale's rounding, in one
    process from the image's first row, on a shard from the shard's.  So
    ``MSRResNet``'s skip may differ by that much of the largest step
    between LR values (inputs in [0, 1]: at most 1) on top of the
    rounding steps."""
    got, one = runs['ranks']['1x4'][0]['plain'][arch, sf]
    assert tuple(got.shape) == (BATCH, sf * G_LR, sf * G_LR, 3)
    position = 0.0
    if arch == 'MSRResNet':
        position = sf * (G_LR + 2 * MARGINS) * abs(
            float(np.float32(1 / sf)) - 1 / sf)
    assert _gap(got, one) <= FP32_STEPS * float(one.abs().max()) + position


def test_halo_exchange_and_adjoint_with_wide_halos(runs):
    got = runs['ranks']['1x4']
    full = torch.cat([r['halo']['x'] for r in got], 1)
    offs = np.cumsum((0,) + HALO_HEIGHTS)
    for i, r in enumerate(got):
        lo = max(0, offs[i] - HALO_TOP)
        hi = min(offs[-1], offs[i + 1] + HALO_BOTTOM)
        assert torch.equal(r['halo']['y'], full[:, lo:hi])
    # halos of 5 and 6 rows over shards of 1-4 rows span several ranks
    assert max(HALO_HEIGHTS) < min(HALO_TOP, HALO_BOTTOM)
    dots = got[0]['halo']['dots']
    assert abs(float(dots[0] - dots[1])) < 1e-12 * abs(float(dots[0]))


def test_errors(runs):
    from exsr_torch.cem.cem import CEM, CEMConf
    from exsr_torch.ops.resize import gaussian_2d
    from exsr_torch.parallel import spatial
    from exsr_torch.parallel.mesh import Mesh, ShardingRules, make_mesh
    for res in runs['ranks']['1x4']:
        assert 'mesh 3x1 != 4 ranks' in res['error(3, 1)']
        assert 'spatial 3 does not divide' in res['error(None, 3)']
    with pytest.raises(ValueError, match='mesh 2x1 != 1 ranks'):
        make_mesh(data=2, spatial=1, device='cpu')
    cpu = torch.device('cpu')
    with pytest.raises(ValueError, match='do not divide the height 32'):
        ShardingRules(Mesh(1, 3, cpu)).shard_batch(np.zeros((2, 32, 8, 3)))
    with pytest.raises(ValueError, match='do not divide the batch 3'):
        ShardingRules(Mesh(2, 1, cpu)).shard_batch(np.zeros((3, 8, 8, 3)))
    mesh = make_mesh(device='cpu')
    assert mesh.device == mesh.dp.device == cpu
    if not torch.cuda.is_available():
        # the entry points' rule: CUDA unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            make_mesh()
    filt = CEM.create(CEMConf(scale_factor=4)).device_filters(3, 'cpu')
    apply = spatial.cem_wrap(lambda p, a, b, r: b[..., :3], filt, SF)
    with pytest.raises(ValueError, match='is not the x4 of the lr shard'):
        apply(None, torch.zeros(1, 8, 8, 3), torch.zeros(1, 30, 32, 3), 0,
              False, mesh)
    even = CEM.create(CEMConf(scale_factor=3),
                      upscale_kernel=gaussian_2d(1.0, 13)).device_filters(
        3, 'cpu')
    rows = spatial.Rows.equal(mesh, 8)
    with pytest.raises(ValueError, match='taps along H'):
        spatial.enforce(even, torch.zeros(1, 8, 8, 3),
                        torch.zeros(1, 24, 24, 3), rows)


@pytest.mark.parametrize('sf', [2, 3, 4])
def test_z_resize_needs_no_halo(sf):
    """Each LR row's bilinear taps lie in its own sf HR rows: the resize of
    a shard is the shard of the resize, bit for bit."""
    from exsr_torch.ops.filters import bilinear_resize
    z = torch.from_numpy(np.random.default_rng(sf).uniform(
        size=(2, sf * 12, sf * 5, 3)).astype(np.float32))
    full = bilinear_resize(z, 12, 5)
    for lo, hi in ((0, 3), (3, 7), (7, 12)):
        part = bilinear_resize(z[:, sf * lo:sf * hi], hi - lo, 5)
        assert torch.equal(part, full[:, lo:hi])
