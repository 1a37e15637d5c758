"""The check for JAX compares whole top-level module names."""

import pytest

from portbench.harness import nojax


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("lanpaint_tpu", True), ("lanpaint_tpu.api", True),
    ("lanpaint_tpu_torch", False), ("lanpaint_tpu_torch.api", False), ("jaxtyping", False),
    ("flaxen", False), ("torch", False), ("portbench.harness", False)])
def test_top_level_names_whole(name, bad):
    assert nojax.loaded({name: None}) == ([name] if bad else [])


def test_harness_imports_no_jax():
    """Importing the harness, the reference and the port's modules the
    cells use loads none of them (in a fresh interpreter)."""
    import subprocess
    import sys

    from portbench.harness import files

    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.harness.runner, portbench.reference.unet, portbench.reference.dit;"
            "import lanpaint_tpu_torch.api, lanpaint_tpu_torch.models.zoo;"
            "from portbench.harness import nojax; print(nojax.loaded())") % str(files.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
