"""Bytes one slot-pool step reads, beside its device time: the counterpart
of the repository's `tools/probe_slots_hlo.py`.

The reference asks XLA's `cost_analysis()` for the compiled step's bytes.
Eager PyTorch has no compiled program to ask, so the port reckons the same
figure from the tensors one `D.pool_step` reads (`step_bytes`), each once:
  weights  the decoder's parameters (every block's linears and norms but
           the cross-attention's key and value projections, which only
           admission runs; the final norm and the token embedding, which
           the logits read whole; of the positional table the S rows the
           step takes);
  pages    the self-KV pages of every slot (int8 with their per-token
           scales, or bf16) and, with int8 pages, the ring;
  cross    the cross-KV pages (int8 with their per-channel scales, or bf16);
  state    the rest of `D.PoolState` (the logits the step samples from,
           tokens, rule state).
It prints that figure and the floor it sets at 3.35 TB/s beside the
step's device busy time, launches and host time, which it takes from the
slot microbench's step row (`microbench_slots.step_row`: host ms over
`--steps` steps, one profiled step).

    python -m speaksense_tpu_torch.tools.probe_slots
    python -m speaksense_tpu_torch.tools.probe_slots --slots 4 --device cpu

Flags: --slots (64), --t-mel (512), --max-new (96), --int8-kv/--no-int8-kv
(int8 cross-KV, on, as the reference's probe), --self-int8/--no-self-int8
(int8 self pages and their ring, on), --model (large-v3), --steps (10),
--seed, --device (cuda; no card raises), --out (the sidecar). The pool's
slots are all admitted before the steps are timed.
"""

from __future__ import annotations

import argparse

from speaksense_tpu_torch.models import whisper as W
from speaksense_tpu_torch.tools import measure as M


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def step_bytes(pool) -> dict:
    """Bytes one pool step reads, by kind, and their total."""
    st, dec = pool.state, pool.model.decoder
    rows = st.tokens.shape[0]
    weights = sum(_nbytes(p) for name, p in dec.named_parameters()
                  if name != "pos" and ".ck." not in name and ".cv." not in name)
    weights += rows * dec.pos.shape[1] * dec.pos.element_size()
    pages = st.pages
    out = {
        "weights": weights,
        "pages": sum(_nbytes(t) for t in (pages.self_k, pages.self_v, pages.self_ks,
                                          pages.self_vs, pages.ring_k, pages.ring_v)
                     if t is not None),
        "cross": sum(_nbytes(t) for t in (pages.cross_k, pages.cross_v, pages.cross_ks,
                                          pages.cross_vs) if t is not None),
        "state": sum(_nbytes(v) for k, v in vars(st).items() if k != "pages"),
    }
    out["total"] = sum(out.values())
    return out


def main(argv=None, dims: W.WhisperDims | None = None) -> dict:
    from speaksense_tpu_torch.runtime.slots import SlotPool
    from speaksense_tpu_torch.tools.bench import _engine
    from speaksense_tpu_torch.tools.microbench_slots import step_row

    on = argparse.BooleanOptionalAction
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--t-mel", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--int8-kv", action=on, default=True)
    ap.add_argument("--self-int8", action=on, default=True)
    ap.add_argument("--model", default="large-v3", choices=tuple(W.MODEL_DIMS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = M.resolve_device(args.device)
    dims = dims or W.MODEL_DIMS[args.model]
    engine = _engine(dims, device, args.seed, cross_kv_int8=args.int8_kv)
    pool = SlotPool(engine, n_slots=args.slots, t_mel=args.t_mel, max_new=args.max_new,
                    int8_kv=args.int8_kv, self_int8=args.self_int8)
    row = step_row(pool, device, args.steps)
    nbytes = step_bytes(pool)
    busy, launches = row["device_busy_ms"], row["launches"]
    floor_ms = 1e3 * nbytes["total"] / M.PEAK_BYTES_PER_S
    card = M.card(device)
    kinds = ", ".join(f"{k} {v / 1e9:.4f} GB" for k, v in nbytes.items() if k != "total")
    print(f"probe: a pool step of {args.slots} slots (t_mel {args.t_mel}, max_new "
          f"{args.max_new}, int8 cross-KV {args.int8_kv}, int8 self pages {args.self_int8}) "
          f"reads {nbytes['total'] / 1e9:.4f} GB ({kinds}): a floor of {floor_ms:.3f} ms at "
          f"3.35 TB/s; device busy {M.fmt_ms(busy)} per step, {launches} launches per step, "
          f"host {row['host_ms']:.3f} ms per step [{card}]", flush=True)
    result = {"metric": f"bytes one pool step reads, beside its device time (S={args.slots}; "
                        f"port, {device.type})",
              "bytes": nbytes, "floor_ms": floor_ms, "device_busy_ms": busy,
              "launches": launches, "host_ms": row["host_ms"],
              "floor_share": None if busy is None else floor_ms / busy,
              "top_kernels": row["top_kernels"], **M.stamp(device)}
    result["total_bytes"] = nbytes["total"]
    return M.emit(result, ("metric", "total_bytes", "floor_ms", "device_busy_ms", "launches",
                           "card"), args.out, "probe_slots")


if __name__ == "__main__":
    main()
