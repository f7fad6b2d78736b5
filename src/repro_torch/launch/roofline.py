"""Roofline terms of (arch x shape) cells on one NVIDIA H100, the
reference's ``launch/roofline.py`` in PyTorch.

Per cell record (``launch.dryrun.run_cell``):

    compute    = dot FLOPs / 989 TFLOP/s (bf16 products, the tensor cores)
    memory     = HBM bytes / 3.35 TB/s (band: lower = 2 x unique writes,
                 upper = per-consumer traffic)
    collective = collective bytes / 450 GB/s (NVLink, each way) -- one
                 card exchanges nothing, so a one-card record carries no
                 collective bytes and has no collective term

plus MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill/decode), N = active
params, D = tokens -- and the usefulness ratio MODEL_FLOPS / dot FLOPs.
The projected roofline fraction is compute_term / max(all terms).  The
port's dry-run report has no compiled program to count dot FLOPs or HBM
bytes in; a record carries them when it has measured or counted them.

``--cim-sweep`` routes every architecture's GEMM mix through the DSE
service (``repro_torch.service``): per-arch best-EE and best-Th
co-explorations stream out as both of an arch's jobs finish, through the
``strategy_eval`` kernel on the card (``--device cpu`` for the plain
version on the CPU).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

PEAK_FLOPS = 989e12          # bf16 products / H100 (dense, 700 W)
HBM_BW = 3.35e12             # bytes/s / H100
LINK_BW = 450e9              # bytes/s each way, NVLink, H100 to the others


def cell_flops(cfg, shape, global_batch: int | None = None) -> float:
    """MODEL_FLOPS of ``cfg`` at ``shape`` (batch ``global_batch`` if
    given)."""
    n = cfg.active_params_estimate()
    b = shape.global_batch if global_batch is None else global_batch
    if shape.kind == "train":
        return 6.0 * n * b * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * b * shape.seq_len
    return 2.0 * n * b                          # decode: one token / request


def model_flops(arch_id: str, shape_id: str) -> float:
    from repro_torch.configs import SHAPES, get_arch
    return cell_flops(get_arch(arch_id), SHAPES[shape_id])


def analyze_cell(rec: dict) -> dict | None:
    if rec.get("status") != "OK":
        return None
    flops = rec.get("dot_flops_per_device", 0.0)
    t_comp = flops / PEAK_FLOPS
    up = rec.get("hbm_bytes_per_device", 0.0)
    lo = 2.0 * rec.get("hbm_write_bytes_per_device", 0.0)
    t_mem_hi = up / HBM_BW
    t_mem_lo = lo / HBM_BW
    coll = rec.get("collectives", {}).get("total_bytes", 0)
    terms = {"compute": t_comp, "memory": t_mem_hi}
    if coll:
        terms["collective"] = coll / LINK_BW
    bound = max(*terms.values(), 1e-30)
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], rec["shape"])
    row = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute_s": t_comp, "t_memory_lo_s": t_mem_lo,
        "t_memory_hi_s": t_mem_hi,
        "dominant": dominant,
        "roofline_fraction": t_comp / bound,
        "roofline_fraction_memlo": t_comp / max(
            t_comp, t_mem_lo, terms.get("collective", 0.0), 1e-30),
        "model_flops": mf,
        "dot_flops": flops,
        "useful_ratio": mf / flops if flops else 0.0,
    }
    if coll:
        row["t_collective_s"] = terms["collective"]
    return row


def hint(row: dict) -> str:
    d = row["dominant"]
    if d == "collective":
        return ("shrink/overlap collectives: reduce-scatter grads, bf16 "
                "sync, overlap TP all-reduce with the next matmul")
    if d == "memory":
        if row["shape"].startswith("decode") or row["shape"].startswith("long"):
            return ("weight/cache reads bound one-token decode: raise batch "
                    "per card, quantize KV, fuse cache update")
        return ("cut activation traffic: fuse elementwise chains, less "
                "remat recompute, bf16 master grads")
    return "compute-bound: raise utilization (larger tiles / fusion)"


def build(out_dir: str = "experiments/dryrun", mesh: str = "1x1",
          tag: str = "single") -> list[dict]:
    rows = []
    for p in sorted(glob.glob(os.path.join(out_dir, f"*_{tag}.json"))):
        with open(p) as f:
            rec = json.load(f)
        row = analyze_cell(rec)
        if row and row["mesh"] == mesh:
            row["hint"] = hint(row)
            rows.append(row)
    return rows


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s (lo-hi) | dominant | "
           "roofline frac | 6ND/dot |\n"
           "|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3g} | "
            f"{r['t_memory_lo_s']:.3g}-{r['t_memory_hi_s']:.3g} | "
            f"{r['dominant']} | {r['roofline_fraction']:.3f} | "
            f"{r['useful_ratio']:.2f} |")
    return hdr + "\n".join(lines) + "\n"


def cim_sweep(
    arch_ids: list[str],
    area_budget_mm2: float = 5.0,
    macro_name: str = "vanilla-dcim",
    seq: int = 512,
    method: str = "exhaustive",
    emit=None,
    device="cuda",
) -> list[dict]:
    """Stream per-arch CIM co-exploration rows through the DSE service.

    Submits ``2 x len(arch_ids)`` jobs (best-EE and best-Th per network) in
    one shot to ``default_service(device)``; ``emit`` fires a formatted row
    the moment BOTH of a network's jobs complete, so fast executable
    buckets report while slow ones still sweep.  Returns the per-arch
    records in completion order."""
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import ExploreJob
    from repro_torch.core.macro import get_macro
    from repro_torch.service import as_completed, default_service

    if emit is None:
        emit = lambda s: print(s, flush=True)
    svc = default_service(device)
    macro = get_macro(macro_name)
    t0 = time.perf_counter()
    futures = []
    for arch in arch_ids:
        wl = get_arch(arch).workload(seq=seq)
        for obj in ("ee", "th"):
            futures.append(svc.submit(
                ExploreJob(macro, wl, area_budget_mm2, objective=obj),
                method=method, meta=(arch, obj)))

    done: dict[str, dict] = {a: {} for a in arch_ids}
    rows: list[dict] = []
    for fut in as_completed(futures):
        arch, obj = fut.meta
        done[arch][obj] = fut.result()
        if len(done[arch]) < 2:
            continue
        ee, th = done[arch]["ee"], done[arch]["th"]
        row = {
            "arch": arch, "macro": macro_name,
            "budget_mm2": area_budget_mm2,
            "best_ee_cfg": ee.config.as_tuple(),
            "tops_w": ee.metrics["tops_w"],
            "best_th_cfg": th.config.as_tuple(),
            "gops": th.metrics["gops"],
            "elapsed_s": time.perf_counter() - t0,
            "cached": ee.search.get("cache") == "store",
        }
        rows.append(row)
        emit(f"| {arch} | {macro_name} | {row['best_ee_cfg']} | "
             f"{row['tops_w']:.2f} TOPS/W | {row['best_th_cfg']} | "
             f"{row['gops']:.0f} GOPS | {row['elapsed_s']:.1f}s"
             f"{' (cached)' if row['cached'] else ''} |")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--tag", default="single")
    ap.add_argument("--json", default="experiments/roofline.json")
    ap.add_argument("--md", default="experiments/roofline.md")
    ap.add_argument("--cim-sweep", default=None, metavar="ARCHS",
                    help="comma-separated arch ids (or 'all'): stream CIM "
                         "co-exploration rows via the DSE service instead "
                         "of analyzing dry-run records")
    ap.add_argument("--cim-budget", type=float, default=5.0)
    ap.add_argument("--cim-macro", default="vanilla-dcim")
    ap.add_argument("--device", default="cuda",
                    help="the DSE service's device (cuda, or cpu)")
    args = ap.parse_args()

    if args.cim_sweep:
        from repro_torch.configs import ARCH_IDS
        archs = list(ARCH_IDS) if args.cim_sweep == "all" \
            else args.cim_sweep.split(",")
        print("| arch | macro | best-EE cfg | TOPS/W | best-Th cfg | GOPS "
              "| elapsed |", flush=True)
        rows = cim_sweep(archs, args.cim_budget, args.cim_macro,
                         device=args.device)
        out_dir = os.path.dirname(args.json)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1, default=list)
        return

    rows = build(args.out_dir, tag=args.tag)
    with open(args.json, "w") as f:
        json.dump(rows, f, indent=1)
    md = to_markdown(rows)
    with open(args.md, "w") as f:
        f.write(md)
    print(md)


if __name__ == "__main__":
    main()
