"""The port's two-process runner (``python -m
raytracingpbr_tpu_torch.apps.multihost``) on the CPU: two worker
processes joined over gloo through a file store (no port), four mesh ranks
each, against the same mesh in one process.

* the (8, 1) still is bit-identical to the one-process render;
* a (4, 2) mesh spread over the two processes (the sample ranks' partial
  sums gathered across them) renders the one-process still's bits, and its
  strided frames with a reprojected refresh (the warp gathers the state
  across processes) too;
* three train steps on (4, 2): the losses equal the one-process mesh's bit
  for bit (each rank's loss is added in mesh-rank order), the updated
  albedo within rtol 1e-5 (a process adds its batch's gradients in its own
  order).
"""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_app(*args, timeout=120):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "raytracingpbr_tpu_torch.apps.multihost",
         "--device", "cpu", *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIHOST OK" in proc.stdout, proc.stdout
    return proc.stdout


def test_two_processes_render_bit_identical():
    out = run_app()
    assert "ranks [0, 1, 2, 3] of mesh 8x1" in out
    assert "ranks [4, 5, 6, 7] of mesh 8x1" in out


def test_sample_ranks_and_reprojected_frames_across_processes():
    out = run_app("--resolution", "16", "--mesh", "4x2", "--frames", "3")
    assert "3 frames and a reprojected refresh on 4x2" in out


def test_two_process_train_step_matches_one_process(tmp_path):
    out = run_app("--resolution", "16", "--max-raymarch", "64",
                  "--max-raytrace", "4", "--train-steps", "3",
                  "--out", str(tmp_path))
    assert "train 4x2, 3 steps" in out
    res = np.load(tmp_path / "multihost.npz")
    np.testing.assert_array_equal(res["workers_image"], res["single_image"])
    np.testing.assert_array_equal(res["workers_losses"],
                                  res["single_losses"])
    np.testing.assert_allclose(res["workers_albedo"], res["single_albedo"],
                               rtol=1e-5)
    assert np.isfinite(res["workers_losses"]).all()


def test_runs_on_the_card_unless_asked():
    """Without ``--device cpu`` the runner takes the card; with no card it
    raises before it starts a worker."""
    import pytest
    import torch

    from raytracingpbr_tpu_torch.apps import multihost
    if torch.cuda.is_available():
        pytest.skip("a card is present: the runner would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.main(["--resolution", "8"])
