"""A cell of the benchmark cut to a size the CPU runs in seconds: the
large-v3-turbo batch cell's files (int8 cross-KV and self-KV pages) with
Whisper's layout at d_model 64, two encoder and two decoder layers,
batches of 4 and 134 new tokens (so the int8 self-KV pages and their ring
are on). Its limits are this size's, read on the CPU over every answered
window of 12 seeds: sound runs read a widest logit gap of 0.0012-0.0044, a
mean gap of 1.3e-6 to 1.5e-5 and a no-speech log-probability difference
of 0.0013-0.0039; the reference lowered in the program's place
0.041-0.077, 2.8e-4 to 5.1e-3 and 0.024-0.047; the program's int8
decoder weights 0.0026-0.0089, 2.0e-6 to 1.2e-4 and 0.0013-0.0060, above
the mean gap's limit on 7 of the 12 seeds (at this size their error is
not always larger than the served path's); the planted faults 0.166 or
more on one number or both. The log-probability difference (RMS over the
windows, every answered window of 12 seeds: 3000000019, 45, 100-109)
reads 9.7e-5 to 2.8e-4 in sound runs, 4.0e-3 to 2.0e-2 with the lowered
reference, 1.3e-3 to 1.8e-2 with its encoder alone, 2.8e-4 to 2.6e-3 with
the int8 decoder weights (above its limit on 4 of the 12 seeds), and
5.2e-3 or more under each planted fault (seeds 3000000019 and 7)."""

from __future__ import annotations

import copy

from benchmark import spec

WORKLOAD = "large-v3-turbo.batch64"


def cell(**traffic):
    c = spec.cell(spec.load_json(spec.ROOT / "BENCHMARK.json"), WORKLOAD)
    cfg = copy.deepcopy(c.config)
    cfg.update(d_model=64, encoder_attention_heads=2, decoder_attention_heads=2,
               encoder_layers=2, decoder_layers=2, encoder_ffn_dim=256, decoder_ffn_dim=256)
    cfg["engine"].update(max_batch_size=4, max_decode_len=268)
    cfg["decoding"]["max_new_tokens"] = 134
    c.config = cfg
    c.traffic = {**c.traffic, "tasks": 8, "clips": 16, "check_windows": 4, **traffic}
    c.limits = {"max_logit_gap": {"reading": "gap", "limit": 0.015},
                "mean_logit_gap": {"reading": "mean_gap", "limit": 2e-5},
                "max_no_speech_logprob_diff": {"reading": "no_speech_diff", "limit": 0.008},
                "rms_logprob_diff": {"reading": "logprob_diff", "limit": 7e-4}}
    return c
