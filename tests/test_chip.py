"""Checks that need the card: compiled kernels against their references at
the deployment's real widths (the same checks ``chip_smoke.py`` runs).

Each test takes the ``gpu`` fixture, which skips it where JAX has no GPU.
Run on the card with
``EPIVO_TEST_GPU=1 python -m pytest -m chip tests/test_chip.py``.
"""

import functools

import jax
import numpy as np
import pytest

import chip_smoke as cs
from epivo_tpu.frontend import fast, klt
from epivo_tpu.utils.gpu import lk_loop

pytestmark = pytest.mark.chip


def test_frontend_kernels_at_kitti_width(gpu):
    frames, _ = cs.render_corridor(2)
    cs.phase_kernels(frames[0], frames[1], cs.bench_vo_config().frontend,
                     gpu, jax.devices("cpu")[0])


def test_ba_windows_at_bench_width(gpu):
    cs.phase_ba(cs.load_ba_workload(), cs.bench_ba_config(), gpu,
                jax.devices("cpu")[0], time_it=False)


def test_lk_kernel_compiled_matches_interpret(gpu):
    """klt.track on a rendered KITTI-size pair: the compiled kernel (klt's
    loop on the GPU) against the same kernel in interpret mode on the CPU,
    at the flow tolerances of chip_smoke."""
    frames, _ = cs.render_corridor(2)
    fe = cs.bench_vo_config().frontend
    cpu = jax.devices("cpu")[0]
    kp = jax.tree_util.tree_map(np.asarray, fast.detect(
        jax.device_put(frames[0], cpu), fe.fast_threshold, fe.max_keypoints))
    args = (frames[0], frames[1], kp.xy, kp.valid)

    def track():
        return jax.jit(lambda a, b, p, v: klt.track(
            a, b, p, valid=v, win=fe.klt_window, levels=fe.klt_levels,
            iters=fe.klt_iters, min_eig=fe.klt_min_eig))

    f_gpu = track()(*jax.device_put(args, gpu))
    with lk_loop(functools.partial(klt._lk_iterate_kernel, interpret=True)):
        f_int = track()(*jax.device_put(args, cpu))
    cs.check_flow(f_gpu, f_int, kp.valid, "LK kernel compiled vs interpret")
