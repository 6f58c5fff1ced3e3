"""exsr_torch and chip_smoke.py import no jax, flax, optax or exsr.

The import check runs in a subprocess: this process has JAX loaded
already (tests/conftest.py)."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / 'exsr_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'exsr')


def _modules():
    for path in sorted(PACKAGE.rglob('*.py')):
        parts = path.relative_to(ROOT).with_suffix('').parts
        if parts[-1] == '__init__':
            parts = parts[:-1]
        yield '.'.join(parts)


def test_every_module_imports_with_jax_and_exsr_blocked():
    mods = list(_modules())
    assert 'exsr_torch.ops.kernels.stage4' in mods
    assert 'exsr_torch.ops.kernels.rrdb_block' in mods
    for m in ('apps.session', 'zopt.optimizer', 'zopt.objectives',
              'zopt.histogram', 'zopt.patches', 'ops.structure_tensor',
              'utils.misc', 'apps.eval_sr', 'data.datasets',
              'train.checkpoints', 'options.config', 'models.classifiers',
              'models.vgg', 'utils.color', 'utils.metrics',
              'losses.losses', 'losses.filter_loss',
              'models.discriminators', 'train.controller', 'train.srragan',
              'apps.train_sr', 'utils.logging'):
        assert f'exsr_torch.{m}' in mods
    blocked = '; '.join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    code = (f'import sys; {blocked}; import importlib; '
            f'[importlib.import_module(m) for m in {mods!r}]; '
            'import chip_smoke; '
            f'assert not any(m in sys.modules and sys.modules[m] '
            f'for m in {FORBIDDEN!r}); print("ok")')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == 'ok'


def test_source_scan_finds_no_forbidden_import():
    files = sorted(PACKAGE.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            for name in names:
                assert name.split('.')[0] not in FORBIDDEN, \
                    f'{path.relative_to(ROOT)} imports {name}'
