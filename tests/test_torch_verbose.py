"""The port's verbose line against the JAX package's.

`flat_solve(..., verbose=True)` prints one line per LM iteration in both
packages; the JAX package's format is a contract
(megba_tpu/observability/emit.py, parsed by megba_tpu/utils/curves.py):
`iter k: cost C log10 L accept A pcg_iters P elapsed T ms`.  One verbose
solve of each package on the same seed, float64 (the conftest enables
x64 for JAX), must print the same lines with the elapsed field masked.
"""

import re

import jax
import numpy as np

import megba_tpu.common as jc
from megba_tpu.ops.residuals import make_residual_jacobian_fn
from megba_tpu.solve import flat_solve as j_flat_solve
from megba_tpu.utils.curves import parse_verbose_curve

import megba_tpu_torch as mt

_ELAPSED = re.compile(r"elapsed [0-9.]+ ms")
_COST_LOG10 = re.compile(r"cost (\S+) log10 (\S+) ")


def _lines(text):
    return [_ELAPSED.sub("elapsed <t> ms", ln)
            for ln in text.splitlines() if ln.startswith("iter ")]


def test_verbose_lines_match_jax(capsys):
    s = mt.make_synthetic_bal(num_cameras=6, num_points=60,
                              obs_per_point=3, seed=4, param_noise=1e-2,
                              pixel_noise=0.5)
    args = (s.cameras0, s.points0, s.obs, s.cam_idx, s.pt_idx)
    kw = dict(max_iter=4, epsilon1=1e-12, epsilon2=1e-15)
    capsys.readouterr()
    jres = j_flat_solve(
        make_residual_jacobian_fn(mode=jc.JacobianMode.ANALYTICAL), *args,
        jc.ProblemOption(jacobian_mode=jc.JacobianMode.ANALYTICAL,
                         algo_option=jc.AlgoOption(**kw)), verbose=True)
    jax.block_until_ready(jres.cost)
    jax.effects_barrier()
    want = _lines(capsys.readouterr().out)
    mt.flat_solve(*args, mt.ProblemOption(
        jacobian_mode=mt.JacobianMode.ANALYTICAL,
        algo_option=mt.AlgoOption(**kw)), device="cpu", verbose=True)
    got = _lines(capsys.readouterr().out)
    assert len(want) == int(jres.iterations) >= 2
    assert got == want
    # The JAX package's parser reads every line.
    assert len(parse_verbose_curve("\n".join(got))) == len(got)
    for ln in got:
        cost, log10 = map(float, _COST_LOG10.search(ln).groups())
        assert abs(log10 - np.log10(cost)) <= 1e-3
