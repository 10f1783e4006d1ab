"""Mutation checks of ``chip_smoke.py`` for K14's searches and the fp32
attention forward: each mutation is a copy of the checkout's
``chip_smoke.py`` and ``tae_tpu_torch/`` (its build directory left out) in
``_mut/<name>/`` (gitignored), with one deliberate fault put into a kernel
source, run through its own ``chip_smoke.py``, which must exit 1. The build
directory is keyed by the sources' hash and lies inside the copy, so each
copy builds its own kernels.

* ``no_full_wait``: the bf16 search's consumers no longer wait on a ring
  slot's ``full`` barrier (they read a slot before its TMA loads have
  landed);
* ``ties_le``: the bf16 search's running argmin replaces on ``<=`` (a tie
  goes to the highest index);
* ``pad_norm_zero``: the codes past K, up to a whole 128-code tile, get the
  norm 0 instead of 3.4e38 (the last tile's mask dropped: a zero row then
  wins wherever every real distance is positive);
* ``f32_ties_le``: the fp32 search's running argmin replaces on ``<=``;
* ``f32_attn_last_wait``: the register-tiled fp32 attention skips the
  cp.async wait on its last V chunk (it may read the chunk before it has
  landed).

Prints, for each, the exit code and the copy's ``FAIL`` line; exits 0 only
if every mutated copy exited 1.

    python -m tae_tpu_torch.bench.mutations [name ...]

Needs ``nvcc`` and a CUDA card, as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
CSRC = "tae_tpu_torch/csrc/quantizer.cu"
ATTN = "tae_tpu_torch/csrc/flash_attention.cu"
# (file, text, replacement): the text must be in the file exactly once
MUTATIONS = {
    "no_full_wait": (CSRC, "        mbar_wait(&full[stage], phase);\n", ""),
    "ties_le": (CSRC, "            if (d < best[h]) {\n", "            if (d <= best[h]) {\n"),
    "pad_norm_zero": (CSRC, "  if (lane == 0) cn[code] = code < k ? s : pad;\n",
                      "  if (lane == 0) cn[code] = code < k ? s : 0.f;\n"),
    "f32_ties_le": (CSRC, "            if (d < best[r]) {\n", "            if (d <= best[r]) {\n"),
    "f32_attn_last_wait": (
        ATTN, "      tae::wait_pending(i + 1 < items ? S - 2 : 0);  // V chunk c; the last waits for all\n",
        "      if (i + 1 < items) tae::wait_pending(S - 2);  // V chunk c; the last waits for all\n"),
}
TIMEOUT_S = 900


def mutate(name: str) -> pathlib.Path:
    """The mutated copy's directory."""
    path, old, new = MUTATIONS[name]
    dst = REPO / "_mut" / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copy2(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    shutil.copytree(REPO / "tae_tpu_torch", dst / "tae_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    text = (dst / path).read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: {old!r} is not in {path} exactly once")
    (dst / path).write_text(text.replace(old, new))
    return dst


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help=f"of {sorted(MUTATIONS)} (default: all)")
    args = ap.parse_args(argv)
    ok = True
    for name in args.names or list(MUTATIONS):
        dst = mutate(name)
        try:
            run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=dst,
                                 capture_output=True, text=True, timeout=TIMEOUT_S)
            rc, err = run.returncode, run.stderr
        except subprocess.TimeoutExpired as e:
            rc, err = "timeout", (e.stderr or b"").decode(errors="replace")
        fail = [line for line in err.splitlines() if line.startswith("FAIL")]
        print(f"[{name}] {MUTATIONS[name][0]}: exit {rc}: "
              f"{fail[-1] if fail else '(no FAIL line)'}", flush=True)
        ok &= rc == 1
    print("every mutated copy exited 1" if ok else "a mutated copy did not exit 1")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
