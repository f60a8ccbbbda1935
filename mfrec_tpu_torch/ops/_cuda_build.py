'''
Build-at-first-use for the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface (it may include a header
of ``csrc/``, as K1's four builds include ``half_pass.cuh``).  The first
call to ``load(name)`` compiles it with ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``mfrec_tpu_torch/_build/``, named by a hash
of the source, its headers and the flags, and loads it with ``ctypes``;
later calls (and later processes, while the source is unchanged) reuse
it.  Nothing is downloaded.  A failed build raises with the compiler's
output.
'''
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    '''The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (default
    ``/usr/local/cuda``), else ``nvcc`` on ``PATH``.'''
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in %s and on PATH): the '
                           'CUDA kernels cannot be built' % cand)
    return found


def library_path(name):
    '''Where ``csrc/<name>.cu`` builds to: keyed on the source, the
    ``csrc/`` headers it includes (``#include "x.cuh"``) and the flags.'''
    src = (CSRC / (name + '.cu')).read_bytes()
    for header in re.findall(rb'#include "([^"]+)"', src):
        src += (CSRC / header.decode()).read_bytes()
    h = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / ('lib%s_%s.so' % (name, h))


def build_log(name):
    '''The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of the current build of ``name``, or None.'''
    log = library_path(name).with_suffix('.log')
    return log.read_text() if log.exists() else None


def build(names):
    '''Compile every ``csrc/<name>.cu`` of ``names`` that has no current
    library yet, one ``nvcc`` each, all started together.  Raises with
    the compiler's output if any fails.'''
    with _lock:
        _build_locked(names)


def _build_locked(names):
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(so.name + '.tmp%d' % os.getpid())
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / (name + '.cu'))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, cmd, proc))
    failed = []
    for name, so, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append('building %s failed (rc %d):\n%s\n%s'
                          % (name, proc.returncode, ' '.join(cmd), out))
            continue
        so.with_suffix('.log').write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError('\n'.join(failed))


def load(name, declare):
    '''The loaded ``ctypes.CDLL`` of ``csrc/<name>.cu``, built if needed;
    ``declare(lib)`` sets its functions' argtypes/restype once.'''
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _build_locked([name])
        lib = ctypes.CDLL(str(library_path(name)))
        declare(lib)
        _libs[name] = lib
        return lib
