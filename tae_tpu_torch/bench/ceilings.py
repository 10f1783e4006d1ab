"""Build and run ``ceilings.cu``: what one Hopper card can do at most for the
kernels' building blocks (``mma.sync`` int8 and bf16 issue rates; the bf16
``wgmma`` rate from shared memory; a three-stage ``cp.async`` ring from L2
into shared memory). The kernels' times in ``PERF.md`` are read against
these.

    python -m tae_tpu_torch.bench.ceilings

Needs ``nvcc`` and a CUDA card; prints the card's name, power limit and SM
clock first.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tempfile

from tae_tpu_torch.ops.cuda import build


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip())
    ghz = float(smi.stdout.strip().splitlines()[0].split(",")[-1]) / 1e3
    src = pathlib.Path(__file__).with_name("ceilings.cu")
    with tempfile.TemporaryDirectory() as tmp:
        exe = pathlib.Path(tmp) / "ceilings"
        flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
        subprocess.run([build.find_nvcc(), *flags, "-o", str(exe), str(src)],
                       check=True, timeout=600)
        return subprocess.run([str(exe), f"{ghz:.3f}"], timeout=600).returncode


if __name__ == "__main__":
    sys.exit(main())
