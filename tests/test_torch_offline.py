"""The port's offline renderer (``raytracingpbr_tpu_torch/apps/offline``)
on the CPU, at a small size: it writes a PNG per frame and a metrics line,
resumes past frames already written, runs both integrators and ``--nee``
(which raises ValueError for a sky that is not HDR, as JAX's app does),
and with no card and no ``--device`` raises rather than render on the
CPU."""
import json
import os

import numpy as np
import pytest
import torch

from raytracingpbr_tpu_torch.apps import offline
from raytracingpbr_tpu_torch.io.image import read_png

ARGS = ["--frames", "1", "--spp", "1", "--scale", "16"]


def test_writes_png_and_metrics(tmp_path, capsys):
    out, metrics = str(tmp_path / "out"), str(tmp_path / "m.jsonl")
    offline.main(["--scene", "cornell_minimal", *ARGS, "--device", "cpu",
                  "--out", out, "--metrics", metrics])
    img = read_png(os.path.join(out, "frame_00000.png"))
    assert img.shape == (32, 32, 3)
    assert img.mean() > 0
    with open(metrics) as f:
        rec = [json.loads(line) for line in f]
    assert len(rec) == 1 and rec[0]["frame"] == 0
    assert rec[0]["samples_per_s"] > 0
    # a second run finds frame 0 and renders nothing
    offline.main(["--scene", "cornell_minimal", *ARGS, "--device", "cpu",
                  "--out", out, "--metrics", metrics])
    assert "resuming at frame 1" in capsys.readouterr().out
    with open(metrics) as f:
        assert len(f.readlines()) == 1


def test_wavefront_integrator(tmp_path):
    out = str(tmp_path / "out")
    offline.main(["--scene", "cornell", *ARGS, "--scale", "24", "--device",
                  "cpu", "--out", out, "--integrator", "wavefront"])
    img = read_png(os.path.join(out, "frame_00000.png"))
    assert img.shape == (20, 20, 3) and img.mean() > 0


def test_nee_needs_an_hdr_sky(tmp_path):
    """JAX's error: ``--nee`` on the black-sky Cornell box raises
    ValueError before anything renders."""
    with pytest.raises(ValueError, match="HDR"):
        offline.main(["--scene", "cornell", *ARGS, "--device", "cpu",
                      "--out", str(tmp_path), "--nee"])
    assert not os.listdir(tmp_path)


def test_nee_demo_writes_png(tmp_path):
    out = str(tmp_path / "out")
    offline.main(["--scene", "demo", *ARGS, "--device", "cpu", "--out", out,
                  "--nee"])
    img = read_png(os.path.join(out, "frame_00000.png"))
    assert img.shape == (27, 48, 3) and img.mean() > 0


def test_no_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline.main(["--scene", "cornell_minimal", *ARGS, "--out",
                      str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_megakernel_frames_draw_their_own_samples(tmp_path):
    """Frame f draws samples f * spp onward, so two frames of a still
    scene differ in their noise."""
    out = str(tmp_path / "out")
    offline.main(["--scene", "cornell_minimal", "--frames", "2", "--spp",
                  "1", "--scale", "32", "--device", "cpu", "--out", out])
    a, b = (read_png(os.path.join(out, f"frame_0000{k}.png"))
            for k in (0, 1))
    assert a.shape == (16, 16, 3)
    assert not np.array_equal(a, b)
