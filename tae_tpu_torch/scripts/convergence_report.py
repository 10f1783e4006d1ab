"""The convergence run's trajectory beside the JAX package's (counterpart
of the parsing half of ``scripts/convergence_report.py``; no curve is
drawn).

Reads the run's JSONL log (``{prefix}_log.txt``, one row an eval, written by
``tae_tpu_torch.cli.train``; the reference train.py:174-182 schema) and, where
given, the run's standard output (``it N: loss: X (Y)`` lines), and prints
markdown tables: the eval trajectory beside the JAX package's run of the same
recipe on the same corpus, the train loss every ``--every`` iterations, and
(``--quant_json``, the JSON line of ``quant_accuracy``) the trained-weights
quantization table beside the JAX run's. The JAX run's values are data
copied from ``docs/CONVERGENCE.md`` (tae_patch16_vocab16_px256, 5000
iterations, batch 256, on one TPU v5e chip); every value is a loss, not a
time.

    python -m tae_tpu_torch.scripts.convergence_report \\
        --run_log .convergence/torch/out/conv_log.txt \\
        --stdout_log .convergence/torch/run.log [--quant_json q.json]
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

IT_RE = re.compile(r"^it (\d+): loss: ([\d.]+) \(([\d.]+)\)")

# docs/CONVERGENCE.md, "Our eval trajectory": iteration -> (train loss,
# eval MSE) of the JAX package's run
JAX_TRAJECTORY = {
    500: (0.0992, 0.0521), 1000: (0.0279, 0.0115), 1500: (0.0090, 0.0112),
    2000: (0.0084, 0.0096), 2500: (0.0079, 0.0097), 3000: (0.0075, 0.0090),
    3500: (0.0066, 0.0075), 4000: (0.0053, 0.0065), 4500: (0.0044, 0.0054),
    5000: (0.0038, 0.0044),
}
# docs/CONVERGENCE.md, the quantization table of the JAX run's best-eval
# checkpoint (256 val images): mode -> (latent rel err, recon MSE)
JAX_QUANT = {
    "bf16": (0.0, 0.00464), "int8": (0.068, 0.01106),
    "int8+eq": (0.0678, 0.01099), "int4": (0.0679, 0.01049),
    "int4+eq": (0.0681, 0.01053), "int4+eq+calib": (0.0718, 0.01098),
}


def parse_jsonl(path: str) -> list[dict]:
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line.startswith("{"):
            rows.append(json.loads(line))
    return rows


def parse_stdout(path: str) -> list[tuple[int, float, float]]:
    """(iteration, window loss, smoothed loss) of the train driver's
    ``--log_freq`` lines, finer than the per-eval JSONL."""
    out = []
    for line in Path(path).read_text(errors="replace").splitlines():
        m = IT_RE.match(line.strip())
        if m:
            out.append((int(m.group(1)), float(m.group(2)),
                        float(m.group(3))))
    return out


def _cell(v, fmt: str = "{:.4f}") -> str:
    return "—" if v is None else fmt.format(v)


def report(evals: list[dict], points=(), quant: dict | None = None,
           every: int = 500) -> str:
    """The markdown tables (see the module's docstring)."""
    lines = ["## Eval trajectory: the port beside the JAX package's run "
             "(losses)", "",
             "| iteration | train loss | eval MSE | JAX train loss | "
             "JAX eval MSE |", "|---|---|---|---|---|"]
    ours = {e["iteration"]: e for e in evals}
    for it in sorted(set(ours) | set(JAX_TRAJECTORY)):
        e = ours.get(it, {})
        jt, je = JAX_TRAJECTORY.get(it, (None, None))
        lines.append(f"| {it} | {_cell(e.get('train_loss'))} | "
                     f"{_cell(e.get('eval_loss'))} | {_cell(jt)} | "
                     f"{_cell(je)} |")
    picked = [p for p in points if p[0] % every == 0]
    if picked:
        lines += ["", f"## Train loss every {every} iterations (the log "
                  "line's window median and running mean)", "",
                  "| iteration | loss | running mean |", "|---|---|---|"]
        lines += [f"| {it} | {w:.4f} | {s:.4f} |" for it, w, s in picked]
    if quant:
        lines += ["", "## Quantized serving on the trained weights "
                  f"({quant.get('images')} val images; encode and decode "
                  "in the mode)", "",
                  "| mode | latent rel err vs bf16 | recon MSE | MSE vs bf16 "
                  "| JAX rel err | JAX MSE |", "|---|---|---|---|---|---|"]
        for name, r in quant["results"].items():
            jr, jm = JAX_QUANT.get(name, (None, None))
            lines.append(f"| {name} | {r['rel_err']:.3g} | {r['mse']:.5f} | "
                         f"{r['mse_delta_pct']:+.2f}% | {_cell(jr, '{:.3g}')}"
                         f" | {_cell(jm, '{:.5f}')} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> str:
    p = argparse.ArgumentParser("the convergence run's tables")
    p.add_argument("--run_log", default=".convergence/torch/out/conv_log.txt")
    p.add_argument("--stdout_log", default="")
    p.add_argument("--quant_json", default="")
    p.add_argument("--every", default=500, type=int)
    p.add_argument("--out_md", default="")
    args = p.parse_args(argv)
    evals = parse_jsonl(args.run_log)
    points = parse_stdout(args.stdout_log) if args.stdout_log else []
    quant = None
    if args.quant_json:
        lines = Path(args.quant_json).read_text().strip().splitlines()
        quant = json.loads(lines[-1])
    if not evals and not points:
        raise SystemExit(f"no eval rows in {args.run_log} and no train "
                         "lines: run the training first")
    text = report(evals, points, quant, args.every)
    print(text)
    if args.out_md:
        Path(args.out_md).write_text(text + "\n")
    return text


if __name__ == "__main__":
    main()
