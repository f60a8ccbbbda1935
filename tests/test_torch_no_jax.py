'''The port stands without JAX: importing it (in a fresh interpreter --
this test session has jax loaded already) pulls in neither jax nor
mfrec_tpu, and no file of the port or of chip_smoke.py imports them.'''
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'mfrec_tpu_torch'
MODULES = ['mfrec_tpu_torch', 'mfrec_tpu_torch.data.ratings',
           'mfrec_tpu_torch.data.movielens', 'mfrec_tpu_torch.utils.math_',
           'mfrec_tpu_torch.engine.checkpoint', 'mfrec_tpu_torch.ops.topk',
           'mfrec_tpu_torch.ops.topn_kernel',
           'mfrec_tpu_torch.ops.half_pass_kernel',
           'mfrec_tpu_torch.ops.sgd_mf', 'mfrec_tpu_torch.engine.trainer',
           'mfrec_tpu_torch.data.ml100k_like',
           'mfrec_tpu_torch.ops._cuda_build',
           'mfrec_tpu_torch.ops.similarity', 'mfrec_tpu_torch.models.base',
           'mfrec_tpu_torch.models.mf', 'mfrec_tpu_torch.models.gd',
           'mfrec_tpu_torch.serving.server', 'mfrec_tpu_torch.interop',
           'mfrec_tpu_torch.ops.als', 'mfrec_tpu_torch.ops.cg_kernel',
           'mfrec_tpu_torch.models.wrmf', 'mfrec_tpu_torch.eval.metrics',
           'mfrec_tpu_torch.ops.window_agg_kernel', 'mfrec_tpu_torch.ops.fn',
           'mfrec_tpu_torch.models.fn']


def _env():
    env = dict(os.environ)
    env['PYTHONPATH'] = str(REPO)
    return env


_PROBE = '''
import importlib, json, sys
def bad():
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "mfrec_tpu"))
out = {}
for name in %r:
    importlib.import_module(name)
    out[name] = bad()
print(json.dumps(out))
'''


@pytest.fixture(scope='module')
def imported():
    '''One fresh interpreter imports the modules in turn and reports the
    jax / mfrec_tpu modules loaded after each.'''
    res = subprocess.run([sys.executable, '-c', _PROBE % (MODULES,)],
                         capture_output=True, text=True, env=_env(),
                         cwd=str(REPO), timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('module', MODULES)
def test_import_pulls_in_no_jax(imported, module):
    assert imported[module] == []


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split('.')[0])
    return roots


def test_no_port_file_imports_jax_or_mfrec_tpu():
    files = sorted(PORT.rglob('*.py')) + [REPO / 'chip_smoke.py']
    assert len(files) > 10
    for f in files:
        bad = _imported_roots(f) & {'jax', 'jaxlib', 'mfrec_tpu'}
        assert not bad, (f, bad)


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    '''Alone in a directory, chip_smoke.py exits non-zero and prints no
    result line.'''
    shutil.copy(REPO / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    res = subprocess.run([sys.executable, 'chip_smoke.py'],
                         capture_output=True, text=True, cwd=str(tmp_path),
                         env=env, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_refuses_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip('this host has a CUDA device')
    res = subprocess.run([sys.executable, 'chip_smoke.py'],
                         capture_output=True, text=True, cwd=str(REPO),
                         env=_env(), timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
