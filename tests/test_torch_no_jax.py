"""The port imports without JAX: the machine with the card has none.

In a fresh interpreter where `import jax` (and flax, safetensors and
ml_dtypes, which that machine lacks too) fails, the package and every
module of it (api, engine, masks, quality, utils, the UNet, DiT, SD3,
HiDream, HunyuanVideo, Z-Image, Wan, VAE, Wan VAE, TAESD, text-encoder and
vision-tower models, the ControlNet and the LoRA merge, the checkpoint
loader and its native reader, the tokenizers, text conditioning, the
pipeline, the server, the web UI, the CLI, the kernel wrappers, the
parallel layer and the example scripts) import,
and nothing of the JAX package (or triton) gets loaded along the way.
"""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = r"""
import sys
for name in ("jax", "flax", "safetensors", "ml_dtypes"):
    sys.modules[name] = None
import lanpaint_tpu_torch
import lanpaint_tpu_torch.api
import lanpaint_tpu_torch.engine
import lanpaint_tpu_torch.masks
import lanpaint_tpu_torch.quality
import lanpaint_tpu_torch.utils
import lanpaint_tpu_torch.models.dit
import lanpaint_tpu_torch.models.hidream
import lanpaint_tpu_torch.models.hyvideo
import lanpaint_tpu_torch.models.layers
import lanpaint_tpu_torch.models.sd3
import lanpaint_tpu_torch.models.taesd
import lanpaint_tpu_torch.models.unet
import lanpaint_tpu_torch.models.vae
import lanpaint_tpu_torch.models.video_vae
import lanpaint_tpu_torch.models.wan
import lanpaint_tpu_torch.models.vision
import lanpaint_tpu_torch.models.zimage
import lanpaint_tpu_torch.models.zoo
import lanpaint_tpu_torch.models.bridge
import lanpaint_tpu_torch.models.load
import lanpaint_tpu_torch.models.textenc
import lanpaint_tpu_torch.native
import lanpaint_tpu_torch.native.loader
import lanpaint_tpu_torch.tokenizers
import lanpaint_tpu_torch.text
import lanpaint_tpu_torch.pipeline
import lanpaint_tpu_torch.models.controlnet
import lanpaint_tpu_torch.models.lora
import lanpaint_tpu_torch.serve
import lanpaint_tpu_torch.webui
import lanpaint_tpu_torch.__main__
import lanpaint_tpu_torch.ops.attention
import lanpaint_tpu_torch.ops.fused
import lanpaint_tpu_torch.ops.norms
import lanpaint_tpu_torch.parallel
import lanpaint_tpu_torch.parallel.mesh
import lanpaint_tpu_torch.parallel.ring
import lanpaint_tpu_torch.examples.common
import importlib
import pkgutil
import lanpaint_tpu_torch.examples
for m in pkgutil.iter_modules(lanpaint_tpu_torch.examples.__path__, "lanpaint_tpu_torch.examples."):
    importlib.import_module(m.name)  # the example scripts
mods = {m.name for m in pkgutil.walk_packages(lanpaint_tpu_torch.__path__, "lanpaint_tpu_torch.")}
missing = sorted(m for m in mods if m not in sys.modules)
assert not missing, f"modules this probe does not import: {missing}"
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "lanpaint_tpu", "triton", "safetensors",
                                       "ml_dtypes")
                and sys.modules[m] is not None)
print("LOADED", loaded)
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_port_sources_name_no_jax():
    pkg = REPO / "lanpaint_tpu_torch"
    for path in sorted(pkg.rglob("*.py")):
        if "_build" in path.relative_to(pkg).parts:  # build outputs, not sources
            continue
        for no, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0].strip()
            bad = (code.startswith(("import jax", "from jax", "import flax", "from flax",
                                    "from lanpaint_tpu ", "from lanpaint_tpu.",
                                    "import lanpaint_tpu ", "import safetensors",
                                    "from safetensors", "import ml_dtypes",
                                    "from ml_dtypes"))
                   or code.startswith("import lanpaint_tpu.") and
                   not code.startswith("import lanpaint_tpu_torch"))
            assert not bad, f"{path.relative_to(REPO)}:{no}: {line.strip()}"
