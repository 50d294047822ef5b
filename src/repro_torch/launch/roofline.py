"""Roofline from dry-run records, for the H100 (PyTorch port of
``repro.launch.roofline``, re-targeted from the reference's TPU v5e).

Per (arch x shape x mesh) cell, the three terms a rank:

  compute    = flops_per_device / PEAK_FLOPS             [s]
  memory     = bytes_per_device / HBM_BW                 [s]
  collective = wire_bytes_per_device / LINK_BW           [s]

Hardware constants: one H100 SXM, 989 TFLOP/s dense bf16 and 3.35 TB/s
of HBM3 (the NVIDIA H100 datasheet; ``PERF.md`` §6 uses the same).  The
interconnect: NVLink 4 gives a GPU 900 GB/s in all (450 GB/s each way,
18 links) to the 7 others of its 8-GPU node; across nodes each GPU has
one NDR InfiniBand port, 400 Gb/s = 50 GB/s each way (the DGX H100:
eight ConnectX-7 at 400 Gb/s).  The production mesh puts ranks
``16 * data + model`` in order on 8-GPU nodes, so a 16-wide ``model``
axis spans two nodes and the ``data`` (and ``pod``) axes span 16 (32);
every ring over a production axis therefore crosses the inter-node
fabric, whose 50 GB/s a GPU is ``LINK_BW`` (the NVLink figure bounds
only axes of at most 8 ranks).

Wire-byte model per collective op (result bytes R, ring algorithms),
as the reference's:
  all-gather           R * (n-1)/n   ~ R
  reduce-scatter       the parsed result is the shard: charged 2R
  all-reduce           2R * (n-1)/n  ~ 2R
  all-to-all           R * (n-1)/n   ~ R

``MODEL_FLOPS`` is the classic 6·N·D (train) / 2·N·D (inference) with N
the ACTIVE parameters (MoE: the top-k experts); the ratio to the counted
FLOPs exposes remat recompute, attention's S² term, replication over a
mesh axis that does not divide a dim, and the eager strategies.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline --in cells.json
       [--out enriched.json]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, apply_vocab
from repro_torch.models.config import ModelConfig

PEAK_FLOPS = 989e12          # bf16 dense, one H100 SXM
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s each way, within an 8-GPU node
LINK_BW = 50e9               # bytes/s each way, NDR InfiniBand, a GPU

_WIRE_FACTOR = {
    "all-gather": 1.0,
    "reduce-scatter": 2.0,
    "all-reduce": 2.0,
    "all-to-all": 1.0,
}


def _block_kinds(cfg: ModelConfig) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for b in cfg.block_pattern:
        out[b] = out.get(b, 0) + 1
    return out


def active_params(cfg: ModelConfig) -> float:
    """Active parameters per token (MoE: routed experts only)."""
    d, dh = cfg.d_model, cfg.d_head
    per_pattern = 0.0
    for kind, cnt in _block_kinds(cfg).items():
        blk = 0.0
        if kind in ("attn", "shared_attn", "cross_attn"):
            blk += d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)  # qkvo
            if kind == "cross_attn":
                blk *= 2
            if cfg.is_moe:
                n_mats = 3
                blk += d * cfg.moe_experts  # router (all tokens)
                blk += cfg.moe_top_k * n_mats * d * cfg.moe_d_ff
            elif cfg.d_ff:
                n_mats = 3 if cfg.act == "swiglu" else 2
                blk += n_mats * d * cfg.d_ff
        elif kind == "mamba2":
            d_inner = cfg.ssm_expand * d
            nh = d_inner // cfg.ssm_head_dim
            blk += d * (2 * d_inner + 2 * cfg.ssm_state + nh)
            blk += d_inner * d
        elif kind == "mlstm":
            blk += d * 3 * d + d * 2 * cfg.n_heads + d * d
        elif kind == "slstm":
            blk += d * 4 * d + d * d
        per_pattern += cnt * blk
    total = per_pattern * cfg.repeats
    total += 2 * cfg.vocab * d          # embed + head
    return total


def model_flops(cfg: ModelConfig, shape, n_devices: int) -> float:
    """Analytic useful FLOPs per device for the cell."""
    n = active_params(cfg)
    if shape.kind == "train":
        total = 6.0 * n * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n * shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        total = 2.0 * n * shape.global_batch
        # attention reads over the KV cache: 2 * 2 * Hkv*Dh * S per layer
        n_attn_layers = sum(
            1 for b in cfg.block_pattern
            if b in ("attn", "shared_attn", "cross_attn")) * cfg.repeats
        total += (4.0 * cfg.n_heads * cfg.d_head * shape.seq_len
                  * n_attn_layers * shape.global_batch)
    return total / n_devices


def _cfg_of(record: dict) -> ModelConfig:
    name = record["arch"]
    cfg = (configs.get_smoke(name) if record.get("config", "")
           .endswith("smoke") else configs.get(name))
    return apply_vocab(cfg, SHAPES[record["shape"]])


def roofline_terms(record: dict) -> dict:
    cfg = _cfg_of(record)
    shape = SHAPES[record["shape"]]
    compute_t = record["flops_per_device"] / PEAK_FLOPS
    memory_t = record["bytes_per_device"] / HBM_BW
    wire = sum(_WIRE_FACTOR.get(k, 1.0) * v
               for k, v in record["collectives"].items())
    coll_t = wire / LINK_BW
    mf = model_flops(cfg, shape, record["n_devices"])
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    dominant = max(terms, key=terms.get)
    bound = max(compute_t, memory_t, coll_t)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / max(record["flops_per_device"], 1),
        # useful work time over the largest term, assuming perfect overlap
        "roofline_fraction": (mf / PEAK_FLOPS) / max(bound, 1e-12),
        "step_time_lower_bound_s": bound,
    }


_ADVICE = {
    "compute": "cut replicated/recomputed FLOPs: heads that divide the "
               "model axis, looser remat, the flash kernel",
    "memory": "raise arithmetic intensity: fuse, bf16 intermediates, "
              "avoid re-streaming weights",
    "collective": "reduce resharding: gather weights not activations, "
                  "overlap collectives with compute",
}


def build_table(records: list) -> str:
    lines = [
        "| arch | shape | mesh | compute_s | memory_s | collective_s | "
        "dominant | MODEL/counted flops | roofline frac | fix |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if "skipped" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | SKIPPED | "
                f"— | — | {r['skipped'][:60]}… |")
            continue
        if "error" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | ERROR | — | — | — | — "
                f"| — | {r['error'][:60]} |")
            continue
        t = roofline_terms(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {t['compute_s']:.3e} | {t['memory_s']:.3e} "
            f"| {t['collective_s']:.3e} | **{t['dominant']}** "
            f"| {t['useful_flops_ratio']:.2f} "
            f"| {t['roofline_fraction']:.3f} "
            f"| {_ADVICE[t['dominant']][:52]}… |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--in", dest="inp", required=True,
                    help="a launch.dryrun --out JSON")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        records = json.load(f)
    table = build_table(records)
    enriched = [r if "skipped" in r or "error" in r
                else {**r, "roofline": roofline_terms(r)} for r in records]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(enriched, f, indent=2, default=str)
    print(table)
    return table


if __name__ == "__main__":
    main()
