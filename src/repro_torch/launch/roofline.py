"""Roofline of the dry-run's records (``launch/dryrun.py``) on a model of an
H100 SXM: the JAX package's ``launch/roofline.py`` for the port.

  PYTHONPATH=src python -m repro_torch.launch.roofline --mesh both

Every quantity is PER RANK (the dry-run traces rank 0 of the production
mesh), so each term is seconds a step on that mesh:

  compute_s     each flop type's count over its rate: 989 TFLOP/s dense
                bf16, 67 TFLOP/s fp32 (TF32 is off for the port's products,
                so they run on the fp32 units), 495 TFLOP/s dense tf32 (the
                fp32 attention backward's 3xTF32); NVIDIA's data sheet for
                the SXM part at its 700 W limit
  memory_s      the bytes the trace counted over 3.35 TB/s of HBM
  collective_s  the wire bytes over 50 GB/s a GPU a direction: one 400 Gb/s
                NDR InfiniBand adapter a GPU, as a DGX H100 has (8 GPUs a
                node, 8 ConnectX-7 ports).  Every axis group of both
                production meshes spans more than one 8-GPU NVLink node:
                ``model`` is 16 consecutive ranks, ``data`` and ``pod`` are
                strided by 16 and 256, so a ring over any of them crosses
                the network, and NVLink 4's 450 GB/s a direction never sets
                its pace here (``axis_nodes``).

``roofline_fraction`` is the model flops over the family's rate (bf16 for
the LM cells, fp32 for the GNN and recsys cells, as the port's chip readings
give model-flops shares) over the largest term; ``model_flops`` is a copy of
the JAX package's.  These are figures of a model of the card, not
measurements.

Not ported, by design:
  * the HLO parser (``parse_module``, ``_multipliers``, ``analyze_hlo``):
    XLA's flat cost analysis counts a while-loop body once, and JAX
    recovers trip counts from the optimized HLO.  An eager trace runs
    every loop iteration, so there is no trip count to recover.
  * the halving of large fp32 collectives: it corrects an XLA:CPU artifact
    (bf16 collectives promoted to fp32); the port's trace sees the dtypes
    the port sends.  ``f32_promoted_bytes`` stays in the output, 0.
"""
from __future__ import annotations

import glob
import json
import math
import os

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
HBM_BW = 3.35e12
LINK_BW = 50e9
NODE_GPUS = 8  # GPUs a DGX H100 node joins by NVLink
FAMILY_RATE = {"lm": "bf16", "gnn": "fp32", "recsys": "fp32"}


def axis_nodes(mesh_shape, axis: int, node: int = NODE_GPUS) -> int:
    """The fewest nodes of ``node`` consecutive ranks that a group along
    ``axis`` of a row-major mesh of ``mesh_shape`` spans."""
    stride, n = math.prod(mesh_shape[axis + 1:]), mesh_shape[axis]
    starts = [r for r in range(math.prod(mesh_shape)) if (r // stride) % n == 0]
    return min(len({(s + i * stride) // node for i in range(n)}) for s in starts)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS per cell (the "useful work" yardstick): JAX's
# ---------------------------------------------------------------------------


def model_flops(meta: dict, n_devices: int) -> float:
    fam = meta["family"]
    if fam == "lm":
        n = meta["active_params"]
        d = meta["tokens"]
        mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[meta["kind"]]
        return mult * n * d / n_devices
    if fam == "gnn":
        h = meta["d_hidden"]
        e, nn, L = meta["n_edges"], meta["n_nodes"], meta["n_layers"]
        per_edge = 2 * (3 * h * h + h * h + h * h)   # edge MLP [3h->h->h->h]
        per_node = 2 * (2 * h * h + h * h + h * h)   # node MLP [2h->h->h->h]
        fwd = L * (e * per_edge + nn * per_node)
        return 3.0 * fwd / n_devices                  # train: fwd + 2x bwd
    # recsys -- MLP/attention flops per sample (embedding gathers are bytes,
    # not flops)
    b = meta["batch"]
    per_sample = {
        "dlrm-rm2": 2 * (13 * 512 + 512 * 256 + 256 * 64 + 415 * 512 + 512 * 512 + 512 * 256 + 256),
        "sasrec": 2 * (2 * (3 * 50 * 50 + 2 * 50 * 50) * 50 + 2 * 50 * 50 * 50),
        "mind": 2 * (50 * 64 * 64 * 3),
        "dien": 2 * (100 * (3 * (18 * 108 + 108 * 108) + 3 * (108 * 108 * 2)) + 126 * 200 + 200 * 80),
    }[meta["arch"]]
    mult = 3.0 if meta["kind"] == "train" else 1.0
    if meta["kind"] == "retrieval":
        per_sample += 2 * meta["n_cand"] * 64
    return mult * b * per_sample / n_devices


# ---------------------------------------------------------------------------
# a record's terms, and the table over a directory of records
# ---------------------------------------------------------------------------


def terms(rec: dict) -> dict:
    """The record's per-rank totals and the three times on the card model."""
    flops_by_dtype = rec["cost"]["flops_by_dtype"]
    coll = rec["collectives"]
    return dict(
        flops=rec["cost"]["flops"],
        bytes=rec["cost"]["bytes accessed"],
        wire_bytes=coll["wire_bytes"],
        f32_promoted_bytes=0.0,
        coll_by_kind={k: c["result_bytes"] for k, c in coll["by_kind"].items()},
        flops_by_dtype=flops_by_dtype,
        compute_s=sum(f / PEAK_FLOPS[k] for k, f in flops_by_dtype.items()),
        memory_s=rec["cost"]["bytes accessed"] / HBM_BW,
        collective_s=coll["wire_bytes"] / LINK_BW,
    )


def analyze_record(json_path: str) -> dict:
    with open(json_path) as f:
        rec = json.load(f)
    t = terms(rec)
    mf = model_flops(rec["meta"], rec["n_devices"])
    out = dict(
        cell=rec["cell"],
        mesh=rec["mesh"],
        n_devices=rec["n_devices"],
        model_flops_per_dev=mf,
        hlo_flops_flat=rec["cost"]["flops"],
        **t,
    )
    out["useful_ratio"] = mf / max(t["flops"], 1.0)
    dom = max(
        ("compute", t["compute_s"]),
        ("memory", t["memory_s"]),
        ("collective", t["collective_s"]),
        key=lambda kv: kv[1],
    )
    out["dominant"] = dom[0]
    out["step_s_bound"] = dom[1]
    denom = max(t["compute_s"], t["memory_s"], t["collective_s"], 1e-30)
    out["roofline_fraction"] = (mf / PEAK_FLOPS[FAMILY_RATE[rec["meta"]["family"]]]) / denom
    out["mem_gib_per_dev"] = round(rec["memory"]["peak_bytes_per_device"] / 2**30, 2)
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", default="experiments/dryrun_torch")
    ap.add_argument("--out", default="experiments/roofline_torch.json")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    args = ap.parse_args(argv)

    rows = []
    for p in sorted(glob.glob(os.path.join(args.dryrun_dir, "*.json"))):
        if args.mesh == "single" and "__multi" in p:
            continue
        if args.mesh == "multi" and "__single" in p:
            continue
        try:
            rows.append(analyze_record(p))
        except Exception as e:  # noqa
            rows.append(dict(cell=os.path.basename(p), error=repr(e)))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)

    print("a model of one H100 SXM a rank (989 / 67 / 495 TFLOP/s bf16 / fp32 / tf32, "
          "3.35 TB/s, 50 GB/s a link), not a measurement")
    hdr = (f"{'cell':42s} {'mesh':8s} {'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
           f"{'dom':>10s} {'roofline%':>9s} {'GiB/dev':>8s}")
    print(hdr)
    for r in rows:
        if "error" in r:
            print(f"{r['cell']:42s} ERROR {r['error']}")
            continue
        print(
            f"{r['cell']:42s} {r['mesh']:8s} "
            f"{r['compute_s']:10.3e} "
            f"{r['memory_s']:10.3e} "
            f"{r['collective_s']:10.3e} "
            f"{r['dominant']:>10s} "
            f"{100 * r['roofline_fraction']:8.1f}% "
            f"{r['mem_gib_per_dev']:8.2f}"
        )
    return rows


if __name__ == "__main__":
    main()
