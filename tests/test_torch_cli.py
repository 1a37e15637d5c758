"""The port's CLI (`python -m lanpaint_tpu_torch`): arg plumbing, image I/O
and the key census, each scenario of tests/test_cli.py against the port.

The inpaint command is driven against a tiny single-file pipeline of the
port (test_torch_serve.tiny_port_pipeline, through a patched builder: the
CLI defaults to full-size configs) so the test covers everything but the
checkpoint's detection: flag parsing, PIL load and save, the pixel-space
conventions and the pipeline's call.  `info` prints the CUDA devices (none
here) and the default config.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import lanpaint_tpu_torch.__main__ as cli
from test_torch_serve import tiny_port_pipeline

REPO = Path(__file__).resolve().parent.parent


def test_info_command(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert "devices:" in out and "device_count:" in out and "default config:" in out


def test_info_runs_as_a_module_without_pil_or_jax():
    """`python -m lanpaint_tpu_torch info` in a fresh interpreter where jax
    and PIL cannot be imported (the card's machine has neither)."""
    probe = ("import sys, runpy\n"
             "for name in ('jax', 'flax', 'PIL'):\n"
             "    sys.modules[name] = None\n"
             "sys.argv = ['lanpaint_tpu_torch', 'info']\n"
             "runpy.run_module('lanpaint_tpu_torch', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "device_count:" in proc.stdout


def test_image_io_roundtrip(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (16, 16, 3), np.uint8)
    p = tmp_path / "in.png"
    Image.fromarray(rgb).save(p)
    arr = cli._load_image(str(p))
    assert arr.shape == (1, 3, 16, 16)
    assert arr.min() >= -1.0 and arr.max() <= 1.0
    q = tmp_path / "out.png"
    cli._save_image(str(q), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), rgb)


def test_mask_io_binarizes(tmp_path):
    from PIL import Image

    g = np.zeros((8, 8), np.uint8)
    g[2:6, 2:6] = 200
    g[0, 0] = 100  # below the 50% threshold
    p = tmp_path / "m.png"
    Image.fromarray(g, "L").save(p)
    m = cli._load_mask(str(p))
    assert m.shape == (8, 8)
    assert m[3, 3] == 1.0 and m[0, 0] == 0.0 and m[7, 7] == 0.0


def test_inpaint_command_end_to_end(tmp_path, monkeypatch):
    from PIL import Image

    pipe = tiny_port_pipeline(tmp_path)
    monkeypatch.setattr(cli, "_build_pipeline", lambda args: pipe)
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8)).save(tmp_path / "in.png")
    m = np.zeros((32, 32), np.uint8)
    m[8:24, 8:24] = 255
    Image.fromarray(m, "L").save(tmp_path / "mask.png")
    out_path = tmp_path / "out.png"
    rc = cli.main([
        "inpaint", "--checkpoint", "unused", "--vocab", "unused", "--merges", "unused",
        "--image", str(tmp_path / "in.png"), "--mask", str(tmp_path / "mask.png"),
        "--output", str(out_path), "--height", "32", "--width", "32", "--steps", "3",
        "--think-steps", "1", "--prompt", "a cat", "--blend-overlap", "3",
    ])
    assert rc == 0
    out = np.asarray(Image.open(out_path))
    assert out.shape == (32, 32, 3)
    # the blend keeps pixels far outside the mask (PNG quantization only)
    inp = np.asarray(Image.open(tmp_path / "in.png"))
    np.testing.assert_allclose(out[:2].astype(int), inp[:2].astype(int), atol=1)


def test_family_flag_routes_to_from_components(monkeypatch, tmp_path):
    """--family flux calls from_components with the component flags."""
    from PIL import Image

    from lanpaint_tpu_torch.pipeline import LanPaintPipeline

    seen = {}

    def fake_from_components(**kw):
        seen.update(kw)
        raise RuntimeError("stop-after-routing")

    monkeypatch.setattr(LanPaintPipeline, "from_components",
                        classmethod(lambda cls, **kw: fake_from_components(**kw)))
    img = tmp_path / "i.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(img)
    with pytest.raises(RuntimeError, match="stop-after-routing"):
        cli.main(["inpaint", "--checkpoint", "model.st", "--family", "flux", "--vae", "ae.st",
                  "--clip-l", "clip.st", "--t5", "t5.st", "--t5-tokenizer", "spiece.model",
                  "--vocab", "v.json", "--merges", "m.txt", "--image", str(img), "--mask",
                  str(img)])
    assert seen["family"] == "flux" and seen["vae"] == "ae.st"
    assert seen["t5"] == "t5.st" and seen["clip_vocab"] == "v.json"


def _write_header_only_ckpt(path, keys):
    """A safetensors file holding `keys` as 1-float tensors: enough for the
    header-only census, which reads no tensor data."""
    from safetensors.numpy import save_file

    save_file({k: np.zeros((1,), np.float32) for k in keys}, str(path))


def test_info_census_exact_match(tmp_path, capsys):
    from lanpaint_tpu_torch.models.zoo import family_expected_keys

    want = family_expected_keys("sd15")
    p = tmp_path / "sd15.safetensors"
    _write_header_only_ckpt(p, want)
    rc = cli.main(["info", "--census", str(p), "--family", "sd15"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "census: OK" in out
    assert f"expected: {len(want)} keys" in out


def test_info_census_reports_diff(tmp_path, capsys):
    from lanpaint_tpu_torch.models.zoo import family_expected_keys

    want = sorted(family_expected_keys("sd15"))
    dropped = want[3]
    p = tmp_path / "bad.safetensors"
    _write_header_only_ckpt(p, [k for k in want if k != dropped] + ["bogus.extra.weight"])
    rc = cli.main(["info", "--census", str(p), "--family", "sd15"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "census: MISMATCH" in out and dropped in out and "bogus.extra.weight" in out


def test_info_census_fp8_scale_companions_ignored(tmp_path):
    from lanpaint_tpu_torch.models.load import safetensors_header_keys

    p = tmp_path / "fp8.safetensors"
    _write_header_only_ckpt(p, ["a.weight", "a.scale_weight", "b.weight"])
    assert set(safetensors_header_keys(str(p))) == {"a.weight", "b.weight"}


def test_info_census_unknown_family(tmp_path):
    p = tmp_path / "x.safetensors"
    _write_header_only_ckpt(p, ["k"])
    with pytest.raises(ValueError, match="no key census"):
        cli.main(["info", "--census", str(p), "--family", "nope"])


def test_family_expected_keys_standins_nonempty():
    from lanpaint_tpu_torch.models.zoo import family_expected_keys

    for fam in ("flux2-dev", "flux2-klein", "krea2", "anima", "qwen", "hidream", "zimage",
                "wan-14b", "wan-5b", "hyvideo", "sdxl", "sd35-large"):
        assert len(family_expected_keys(fam)) > 50, fam


def test_flags_match_the_jax_cli():
    """Every subcommand takes the JAX CLI's flags, with the same defaults,
    but `--chunk-steps` (the JAX package's chunked launches; the port runs a
    ladder in one loop)."""
    import argparse

    import lanpaint_tpu.__main__ as jcli

    def parsers(mod):
        captured = {}
        real = argparse.ArgumentParser.parse_args

        def capture(self, argv=None, namespace=None):
            captured["parser"] = self
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                mod.main(["info"])
        finally:
            argparse.ArgumentParser.parse_args = real
        sub = next(a for a in captured["parser"]._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {name: {a.dest: (a.option_strings, a.default, a.choices)
                       for a in p._actions if a.dest != "help"}
                for name, p in sub.choices.items()}

    want = parsers(jcli)
    for flags in want.values():
        flags.pop("chunk_steps", None)
    assert parsers(cli) == want
