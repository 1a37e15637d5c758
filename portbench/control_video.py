"""`control.py` for a cell whose program holds a VAE besides its backbone
(`entries/inpaint_video.py`): the control puts the plain reference,
computed with float8 e4m3 operands, in the place of both, the DiT through
`control.control_in_place` and the VAE through the configuration's
`build_vae`, so that every compared number has its control reading.

    python3 portbench/control_video.py --workload <cell> --seeds 1,2,3 --control 4,5,6

The options and the lines printed are `control.py`'s.
"""

import time

T0 = time.perf_counter()

import contextlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


class ReferenceVAE:
    """The plain reference VAE computed in `mode`, with the program VAE's
    `encode`, `decode` and `to`."""

    def __init__(self, module, mode: str):
        self.module, self.mode = module, mode

    def encode(self, pixels):
        return self._run(self.module.encode, pixels)

    def decode(self, latent):
        return self._run(self.module.decode, latent)

    def _run(self, fn, x):
        import torch

        from portbench.reference import nn as rnn

        with torch.no_grad(), rnn.precision(self.mode):
            return fn(x)

    def to(self, *args, **kw):
        self.module.to(*args, **kw)
        return self


@contextlib.contextmanager
def control_in_place(config, mode: str = "fp8"):
    """`config.build_program` swapped for `control.reference_in_place` and
    `config.build_vae` for the reference VAE computed in `mode`, inside."""
    from portbench import control

    def build_vae(sizes: dict, state: dict, device):
        module = config.build_reference_vae(sizes)
        module.load_state_dict(state, assign=True)
        module.requires_grad_(False)
        return ReferenceVAE(module, mode)

    real = config.build_program, config.build_vae
    config.build_program = control.reference_in_place(config, mode)
    config.build_vae = build_vae
    try:
        yield
    finally:
        config.build_program, config.build_vae = real


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench import control

    control.control_in_place = control_in_place
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
