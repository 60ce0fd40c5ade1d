"""Multi-GPU serving of the port (speaksense_tpu_torch/parallel) on the CPU:
the mesh and sharding rules against the JAX package's, and the sharded
engine over gloo, one process per rank importing only the port, against the
JAX engine sharded on its 8 virtual CPU devices (tests/conftest.py), on the
same numpy weights in float32. The results meet in a numpy file."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from speaksense_tpu.asr.engine import WhisperEngine as JEngine
from speaksense_tpu.config import EngineConfig as JEngineConfig
from speaksense_tpu.models import whisper as JW
from speaksense_tpu.models.tokenizer import Tokenizer as JTokenizer
from speaksense_tpu.parallel import mesh as JM
from speaksense_tpu_torch.asr.engine import WhisperEngine as TEngine
from speaksense_tpu_torch.config import Config, EngineConfig
from speaksense_tpu_torch.models import decode as TD
from speaksense_tpu_torch.models import whisper as TW
from speaksense_tpu_torch.models.tokenizer import Tokenizer
from speaksense_tpu_torch import main as TMAIN
from speaksense_tpu_torch.parallel import mesh as TM
from speaksense_tpu_torch.parallel import multihost as TH

REPO = Path(__file__).resolve().parent.parent
DIMS = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
                      n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
                      n_text_head=4, n_text_layer=2)
TDIMS = TW.WhisperDims(**DIMS.__dict__)
# quality ladder neutralized: every window and chunk is one greedy attempt
NEVER = dict(compute_dtype="float32", compression_ratio_thold=1e9, logprob_thold=-1e9,
             entropy_thold=-1.0)
# f32 on both sides, the tp partial sums added in other orders: per-token
# log-probabilities agree to a few f32 ulps, their mean to 1e-5
LOGPROB_ATOL = 1e-5


@pytest.fixture(scope="module")
def np_params():
    return JW.init_params_np(DIMS, seed=0)


def _port(np_params, **cfg) -> TEngine:
    return TEngine.from_jax_params(np_params, TDIMS, Tokenizer.synthetic(DIMS.n_vocab),
                                   config=EngineConfig(**{**NEVER, **cfg}), device="cpu")


def _jax(np_params, **cfg) -> JEngine:
    return JEngine(np_params, DIMS, JTokenizer.synthetic(DIMS.n_vocab),
                   config=JEngineConfig(**{**NEVER, **cfg}))


# ---------------------------------------------------------------------------
# the mesh and the sharding rules, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n, tp", [(8, 2), (4, 4), (6, 1)])
def test_mesh_factorization(n, tp):
    got, want = TM.make_mesh(n, tp=tp), JM.make_mesh(n, tp=tp)
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == want.axis_names == ("dp", "tp")
    assert got.shape == dict(want.shape)
    assert got.devices.tolist() == np.arange(n).reshape(-1, tp).tolist()


def _canon_jax(params) -> dict:
    """{(stack, proj, leaf): axis} of the JAX specs of the block linears
    ("out" or "in" of the projection, None for replicated), q/k/v taken as
    the port's fused qkv; every other leaf must be replicated."""
    out = {}

    def visit(path, leaf, spec):
        names = [p.key for p in path]
        if "blocks" not in names or names[-2] in ("attn_ln", "mlp_ln", "cross_ln"):
            assert "tp" not in tuple(spec), (names, spec)
            return
        stack, proj, name = names[0], names[-2], names[-1]
        axis = None
        if "tp" in tuple(spec):
            axis = "out" if tuple(spec).index("tp") == leaf.ndim - 1 else "in"
        key = (stack, "qkv" if proj in ("q", "k", "v") else proj, name)
        assert out.setdefault(key, axis) == axis, key

    import jax

    jax.tree_util.tree_map_with_path(visit, params, JM.param_shardings(params))
    return out


def _canon_port(model) -> dict:
    out = {}
    leaf_names = {"weight": "w", "bias": "b", "wq": "wq", "ws": "ws"}
    params = dict(model.named_parameters())
    for name, spec in TM.param_shardings(model).items():
        parts = name.split(".")
        if "blocks" not in parts or parts[-2].endswith("_ln"):
            assert "tp" not in spec, (name, spec)
            continue
        axis = None
        if "tp" in spec:
            # linear weights are (out, in): dim 0 is the out-features
            axis = "out" if spec.index("tp") == 0 else "in"
        key = (parts[0], parts[-2], leaf_names[parts[-1]])
        assert out.setdefault(key, axis) == axis, key
        assert params[name].dim() == len(spec)
    return out


@pytest.mark.parametrize("layout", ["unfused", "fused", "int8"])
def test_param_shardings_match_jax(np_params, layout):
    params = np_params
    if layout != "unfused":
        params = JW.fuse_qkv_weights(params)
    if layout == "int8":
        params = JW.quantize_block_weights(params)
    model = TW.params_from_jax(params, TDIMS, device="cpu", dtype=torch.float32)
    got, want = _canon_port(model), _canon_jax(params)
    assert got == want
    if layout == "int8":
        assert got[("decoder", "fc2", "ws")] is None and got[("decoder", "fc1", "ws")] == "out"


def _rank1(mesh):
    mesh.tp_index = 1
    return mesh


def test_shard_params_splits_qkv_by_heads(np_params):
    """Rank 1 of tp = 2 keeps its heads of q, of k and of v (not the second
    half of the fused axis), the in-features of the row-parallel layers,
    and every replicated tensor whole; int8 scales follow their rows."""
    params = JW.quantize_block_weights(JW.fuse_qkv_weights(np_params))
    whole = TW.params_from_jax(params, TDIMS, device="cpu", dtype=torch.float32)
    part = TW.params_from_jax(params, TDIMS, device="cpu", dtype=torch.float32)
    TM.shard_params(part, _rank1(TM.make_mesh(2, tp=2)))
    d = DIMS.n_text_state
    h = d // 2
    for stack in ("encoder", "decoder"):
        w, p = getattr(whole, stack).blocks[0], getattr(part, stack).blocks[0]
        leaf = "weight" if stack == "encoder" else "wq"
        qkv = getattr(w.qkv, leaf)
        want = torch.cat([qkv[h:d], qkv[d + h:2 * d], qkv[2 * d + h:]])
        torch.testing.assert_close(getattr(p.qkv, leaf), want, rtol=0, atol=0)
        torch.testing.assert_close(p.qkv.bias, torch.cat(
            [w.qkv.bias[h:d], w.qkv.bias[d + h:2 * d], w.qkv.bias[2 * d + h:]]), rtol=0, atol=0)
        torch.testing.assert_close(getattr(p.o, leaf), getattr(w.o, leaf)[:, h:], rtol=0, atol=0)
        torch.testing.assert_close(p.o.bias, w.o.bias, rtol=0, atol=0)
        torch.testing.assert_close(getattr(p.fc1, leaf), getattr(w.fc1, leaf)[2 * d:],
                                   rtol=0, atol=0)
        assert p.o.reduce is not None and p.fc2.reduce is not None and p.fc1.reduce is None
    dec_w, dec_p = whole.decoder.blocks[1], part.decoder.blocks[1]
    torch.testing.assert_close(dec_p.fc1.ws, dec_w.fc1.ws[2 * d:], rtol=0, atol=0)
    torch.testing.assert_close(dec_p.fc2.ws, dec_w.fc2.ws, rtol=0, atol=0)
    torch.testing.assert_close(dec_p.ck.wq, dec_w.ck.wq[h:], rtol=0, atol=0)
    torch.testing.assert_close(part.decoder.tok_emb, whole.decoder.tok_emb, rtol=0, atol=0)
    assert (part.n_audio_head, part.n_text_head) == (2, 2)
    with pytest.raises(ValueError, match="must divide the head count"):
        TM.shard_params(whole, TM.make_mesh(3, tp=3))


@pytest.mark.parametrize("int8", [False, True])
def test_pool_state_and_cache_shardings_match_jax(np_params, int8):
    """The specs of the pool state's tensors that both packages hold, and
    of the decode cache, are the JAX specs; `shard_pool_state` of the whole
    state gives the shapes the pool of a sharded replica builds."""
    from speaksense_tpu.runtime.slots import SlotPool as JPool

    jc = {k: tuple(v) for k, v in JM.cache_shardings(int8).items()}
    tc = TM.cache_shardings(int8)
    names = {"self_k": "self_k", "self_v": "self_v", "cross_k": "cross_k",
             "cross_v": "cross_v"} | ({"self_ks": "self_k_scale", "self_vs": "self_v_scale"}
                                      if int8 else {})
    assert tc == {k: jc[j] for k, j in names.items()}
    jeng = _jax(np_params)
    jpool = JPool(jeng, n_slots=3, t_mel=512, max_new=8, int8_kv=int8)
    want = {k: tuple(v) for k, v in JM.pool_state_shardings(jpool.state).items()}
    model = TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32)
    cfg = TD.RuleConfig.from_tokenizer(Tokenizer.synthetic(DIMS.n_vocab), max_new_tokens=8)
    whole = TD.PoolState.empty(model, 4, 8, 128, 256, cfg.eot, "cpu", cross_int8=int8,
                               self_int8=int8)
    got = TM.pool_state_shardings(whole)
    common = set(got) & set(want)
    assert {"self_k", "cross_k", "tokens", "last_logits", "active", "temp"} <= common
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    mesh = TM.make_mesh(4, tp=2)
    mesh.dp_index, mesh.tp_index = 1, 1
    part = TM.shard_pool_state(whole, mesh)
    TM.shard_params(model, mesh)
    local = TD.PoolState.empty(model, 2, 8, 128, 256, cfg.eot, "cpu", cross_int8=int8,
                               self_int8=int8)
    assert ({k: tuple(v.shape) for k, v in TM._state_tensors(part).items()}
            == {k: tuple(v.shape) for k, v in TM._state_tensors(local).items()})


def test_slot_rounding_and_shard_order(np_params):
    """enable_slot_serving rounds the slot count down so S+1 divides dp, as
    the JAX engine does, and shard() after it raises."""
    jeng = _jax(np_params)
    jeng.shard(JM.make_mesh(8, tp=2))               # dp = 4
    teng = _port(np_params)
    teng.shard(TM.make_mesh(8, tp=1))               # a layout mesh: dp = 8, no process group
    try:
        for n in (5, 8):
            jeng.enable_slot_serving(n_slots=n, t_mel=512, max_new=8)
            teng.enable_slot_serving(n_slots=n + 2, t_mel=512, max_new=8)
            js, ts = jeng._slot_server.pool, teng._slot_server.pool
            assert (js.S + 1) % 4 == 0 and (ts.S + 1) % 8 == 0 and ts.S == 7
            assert (ts.R, ts.base, ts.state.active.shape[0]) == (1, 0, 1)
            with pytest.raises(RuntimeError, match="before enable_slot_serving"):
                teng.shard(TM.make_mesh(8, tp=1))
            jeng.disable_slot_serving()
            teng.disable_slot_serving()
        assert teng._slot_server is None and teng._pool is None
    finally:
        jeng.disable_slot_serving()
        teng.disable_slot_serving()


def test_init_distributed_noop_without_env(monkeypatch):
    from speaksense_tpu.parallel import init_distributed as jinit

    for var in ("SPEAKSENSE_COORDINATOR", "SPEAKSENSE_NUM_PROCESSES", "SPEAKSENSE_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert TH.init_distributed() is jinit() is False
    # an explicit single process is a no-op too
    assert TH.init_distributed("localhost:1234", 1, 0) is False
    assert TH.distributed_env() is None
    monkeypatch.setenv("SPEAKSENSE_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("SPEAKSENSE_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="SPEAKSENSE_PROCESS_ID"):
        TH.init_distributed()
    monkeypatch.setenv("SPEAKSENSE_PROCESS_ID", "1")
    assert TH.distributed_env() == ("localhost:1234", 2, 1)
    assert not torch.distributed.is_initialized()


def test_main_checks_tp_times_dp(monkeypatch):
    """JAX main's rule: tp x dp above the local cards raises; dp defaults to
    the cards // tp; one rank and no coordinator builds no process group."""
    monkeypatch.delenv("SPEAKSENSE_COORDINATOR", raising=False)
    monkeypatch.delenv("SPEAKSENSE_NUM_PROCESSES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    config = Config()
    assert TMAIN.serving_layout(config) == (1, 4)
    config.tp = 2
    assert TMAIN.serving_layout(config) == (2, 2)
    config.dp = 3
    with pytest.raises(ValueError, match="tp=2 x dp=3 exceeds 4 local devices"):
        TMAIN.serving_layout(config)
    assert TMAIN.serving_layout(config, device="cpu") == (2, 3)
    spec = TMAIN.worker_spec(config, 2, 2)
    assert spec.devices == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"] and spec.tp == 2
    assert spec.init["local_ranks"] == 4 and spec.init["num_processes"] == 1
    assert TMAIN.worker_spec(config, 1, 1) is None


# ---------------------------------------------------------------------------
# the sharded engine over gloo, one process per rank
# ---------------------------------------------------------------------------

_LEADER = textwrap.dedent("""
    import sys, numpy as np, torch
    torch.set_num_threads(1)
    from speaksense_tpu_torch.asr.engine import WhisperEngine
    from speaksense_tpu_torch.config import EngineConfig
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.models.tokenizer import Tokenizer
    from speaksense_tpu_torch.parallel.workers import (WorkerSpec, free_port, join_mesh,
                                                       start_workers, stop_workers,
                                                       watch_workers)

    def build(npz, device="cpu"):
        z = np.load(npz, allow_pickle=True)
        dims = W.WhisperDims(**z["dims"].item())
        return WhisperEngine.from_jax_params(z["params"].item(), dims,
                                             Tokenizer.synthetic(dims.n_vocab),
                                             config=EngineConfig(**z["config"].item()),
                                             device=device)

    if __name__ == "__main__":
        npz, out, tp, dp = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
        spec = WorkerSpec(init=dict(coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                                    process_id=0, local_ranks=tp * dp),
                          tp=tp, devices=["cpu"] * (tp * dp), build=build, build_args=(npz,))
        procs = start_workers(spec)
        mesh = None
        res = {}
        try:
            mesh = join_mesh(spec, 0)
            watch_workers(mesh, procs)
            eng = build(npz)
            eng.shard(mesh)
            z = np.load(npz, allow_pickle=True)
            rows = eng.decode_windows(z["mels"], "en", max_new_tokens=8 if z["chunks"].size else 32)
            res["window_tokens"] = np.stack([r["tokens"] for r in rows])
            res["window_n"] = np.asarray([r["n_sampled"] for r in rows])
            res["window_lp"] = np.asarray([r["avg_logprob"] for r in rows])
            res["first_enc"], res["first_logits"] = (t.numpy() for t in eng.first_step(z["mels"]))
            for beam in (1, 2) if z["chunks"].size else ():
                eng.enable_slot_serving(n_slots=4, t_mel=512, max_new=8, beam_size=beam)
                pool = eng._slot_server.pool
                futs = [eng._slot_server.submit(m) for m in z["chunks"][:5 if beam == 1 else 3]]
                got = [f.result(timeout=120) for f in futs]
                res[f"pool{beam}_S"] = pool.S
                res[f"pool{beam}_rows"] = pool.state.active.shape[0]
                res[f"pool{beam}_tokens"] = np.stack([g["tokens"] for g in got])
                res[f"pool{beam}_n"] = np.asarray([g["n_sampled"] for g in got])
                res[f"pool{beam}_lp"] = np.asarray([g["avg_logprob"] for g in got])
                eng.disable_slot_serving()
        finally:
            stop_workers(mesh, procs)
        res["exitcodes"] = np.asarray([p.exitcode for p in procs])
        np.savez(out, **res)
        print("LEADER_OK")
""")


def _run(args, tmp_path, name, timeout=240, env=None):
    """Start a port-only process (no jax on its path of imports)."""
    env = {**os.environ, **(env or {}), "PYTHONPATH": str(REPO)}
    log = open(tmp_path / f"{name}.log", "w")
    proc = subprocess.Popen([sys.executable, *args], cwd=tmp_path, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    return proc, log


def _finish(proc, log, tmp_path, name, timeout=240):
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / f"{name}.log").read_text()
    assert rc == 0, text[-4000:]
    return text


@pytest.fixture(scope="module")
def sharded(np_params, tmp_path_factory):
    """The port's engine sharded dp = 2 x tp = 2 over gloo (4 processes):
    two 30 s windows through the window path (replicated over dp, tp = 2),
    then 5 chunks through the greedy pool and 3 through the beam pool
    (K = 2), both asked for 4 slots, which round down to 3 (S+1 = 4 rows,
    2 on each dp replica). The JAX side runs while the processes do."""
    tmp = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(5)
    mels = rng.standard_normal((2, 3000, DIMS.n_mels)).astype(np.float32) * 0.5
    chunks = rng.standard_normal((5, 512, DIMS.n_mels)).astype(np.float32) * 0.5
    _save_inputs(tmp / "in.npz", np_params, DIMS, mels, chunks)
    (tmp / "leader.py").write_text(_LEADER)
    proc, log = _run(["leader.py", "in.npz", "out.npz", "2", "2"], tmp, "leader")

    jax_side = {}
    jeng = _jax(np_params)
    jeng.shard(JM.make_mesh(8, tp=2))
    rows = jeng.decode_windows(mels, "en", max_new_tokens=8)
    jax_side["window"] = rows
    jax_side["first_step"] = tuple(t.numpy() for t in _port(np_params).first_step(mels))
    for beam in (1, 2):
        jpool = _jax(np_params)
        jpool.shard(JM.make_mesh(4, tp=2))         # dp = 2, tp = 2
        jpool.enable_slot_serving(n_slots=4, t_mel=512, max_new=8, beam_size=beam)
        try:
            jax_side[f"pool{beam}_S"] = jpool._slot_server.pool.S
            futs = [jpool._slot_server.submit(m) for m in chunks[:5 if beam == 1 else 3]]
            jax_side[f"pool{beam}"] = [f.result(timeout=300) for f in futs]
        finally:
            jpool.disable_slot_serving()
    text = _finish(proc, log, tmp, "leader")
    assert "LEADER_OK" in text, text[-3000:]
    return dict(np.load(tmp / "out.npz")), jax_side


def _same(got_tokens, got_n, got_lp, want: list):
    for i, w in enumerate(want):
        n = int(w["n_sampled"])
        assert int(got_n[i]) == n, i
        np.testing.assert_array_equal(got_tokens[i][:n], np.asarray(w["tokens"])[:n])
        assert abs(float(got_lp[i]) - float(w["avg_logprob"])) <= LOGPROB_ATOL


def _save_inputs(path, np_params, dims, mels, chunks):
    np.savez(path, params=np.asarray(np_params, dtype=object),
             dims=np.asarray(dims.__dict__, dtype=object), config=np.asarray(NEVER, dtype=object),
             mels=mels, chunks=chunks)


@pytest.mark.parametrize("path", ["window_tp2", "greedy_pool_dp2_tp2", "beam_pool_dp2_tp2"])
def test_sharded_engine_matches_jax(sharded, path):
    """(a) the tp = 2 window path against the JAX engine sharded on
    make_mesh(8, tp=2); (b) the dp = 2 x tp = 2 greedy pool and (c) the
    beam pool against the JAX pools on make_mesh(4, tp=2): the same tokens,
    avg_logprob within 1e-5, the same rounded slot count."""
    got, want = sharded
    assert list(got["exitcodes"]) == [0, 0, 0]
    if path == "window_tp2":
        _same(got["window_tokens"], got["window_n"], got["window_lp"], want["window"])
        # the encoder states and first-step logits against one process
        enc, logits = want["first_step"]
        np.testing.assert_allclose(got["first_enc"], enc, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["first_logits"], logits, rtol=1e-5, atol=1e-4)
        return
    beam = 1 if path.startswith("greedy") else 2
    assert int(got[f"pool{beam}_S"]) == want[f"pool{beam}_S"] == 3
    assert int(got[f"pool{beam}_rows"]) == 2          # (S + 1) / dp rows on the leader
    _same(got[f"pool{beam}_tokens"], got[f"pool{beam}_n"], got[f"pool{beam}_lp"],
          want[f"pool{beam}"])


_FAULTS = textwrap.dedent("""
    import sys, time, numpy as np, torch
    torch.set_num_threads(1)
    from speaksense_tpu_torch.asr.engine import WhisperEngine
    from speaksense_tpu_torch.config import EngineConfig
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.models.tokenizer import Tokenizer
    from speaksense_tpu_torch.parallel.workers import (WorkerSpec, free_port, join_mesh,
                                                       start_workers, stop_workers,
                                                       watch_workers)

    def planted(*args, **kwargs):
        raise RuntimeError("planted fault")

    def build(npz, fault, device="cpu"):
        z = np.load(npz, allow_pickle=True)
        dims = W.WhisperDims(**z["dims"].item())
        eng = WhisperEngine.from_jax_params(z["params"].item(), dims,
                                            Tokenizer.synthetic(dims.n_vocab),
                                            config=EngineConfig(**z["config"].item()),
                                            device=device)
        if fault == "follower" and torch.distributed.get_rank() != 0:
            eng.detect_language = planted          # what the leader's call runs there
        return eng

    if __name__ == "__main__":
        npz, out, fault = sys.argv[1], sys.argv[2], sys.argv[3]
        spec = WorkerSpec(init=dict(coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                                    process_id=0, local_ranks=2),
                          tp=2, devices=["cpu", "cpu"], build=build, build_args=(npz, fault))
        procs = start_workers(spec)
        mesh = None
        res = {}
        try:
            mesh = join_mesh(spec, 0)
            watch_workers(mesh, procs)
            eng = build(npz, fault)
            eng.shard(mesh)
            mels = np.load(npz)["mels"]
            res["enc"], res["logits"] = (t.float().numpy() for t in eng.first_step(mels))
            # a fault every rank shares (a mel of the wrong width): the mesh goes on
            try:
                eng.first_step(mels[:, :, :7])
            except Exception as e:
                res["shared"] = repr(e)
            res["enc_after"] = eng.first_step(mels)[0].float().numpy()
            if fault == "leader":
                W.encode = planted                 # on this rank only
            t0 = time.monotonic()
            try:
                eng.detect_language(np.zeros(16000, np.float32))
            except Exception as e:
                res["fault"], res["fault_s"] = repr(e), time.monotonic() - t0
            t0 = time.monotonic()
            try:
                eng.first_step(mels)
            except Exception as e:
                res["after"], res["after_s"] = repr(e), time.monotonic() - t0
        finally:
            stop_workers(mesh, procs)
        res["exitcodes"] = np.asarray([p.exitcode for p in procs])
        np.savez(out, **res)
        print("LEADER_OK")
""")

# bf16 tp = 2 against the unsharded bf16 port, relative L2: each row-parallel
# sum is the f32 sum of two partial products, rounded once, where unsharded
# it is one product; the rest is the same arithmetic. Readings: encoder
# states 1.13e-4, first-step logits 3.13e-3; with the partials rounded to
# bf16 before the all-reduce (rounding twice) 2.83e-3 and 6.22e-3. The
# decoder's bf16 activations turn any f32 difference into flips of a bf16
# ulp, so the logits' limit is loose (rounding twice passes it) and the
# encoder's, with test_row_parallel_linear_rounds_once, catches that fault
BF16_ENC_RTOL = 5e-4
BF16_LOGITS_RTOL = 1e-2


@pytest.mark.parametrize("kind", ["bias", "no_bias", "int8"])
def test_row_parallel_linear_rounds_once(kind):
    """A bf16 row-parallel layer of tp = 2 (`_linear` with `Linear.reduce`,
    here the other shard's f32 partial added in process) equals the whole
    layer bit for bit: the partials are summed in f32 and the bias added
    before the one rounding. Rounding the partials to bf16 first changes
    21-28% of the outputs."""
    g = torch.Generator().manual_seed(1)
    d_in, d_out, h = 256, 192, 128
    whole = TW.Linear(d_in, d_out, bias=kind != "no_bias", device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        whole.weight.copy_(torch.randn(d_out, d_in, generator=g) * 0.05)
        if whole.bias is not None:
            whole.bias.copy_(torch.randn(d_out, generator=g))
    if kind == "int8":
        whole.quantize_()
    x = torch.randn(64, d_in, generator=g).to(torch.bfloat16)
    shards = []
    for i in range(2):
        part = TW.Linear(h, d_out, bias=kind != "no_bias", device="cpu", dtype=torch.bfloat16)
        with torch.no_grad():
            if kind == "int8":
                part.set_int8_(whole.wq[:, i * h:(i + 1) * h], whole.ws)
            else:
                part.weight.copy_(whole.weight[:, i * h:(i + 1) * h])
            if part.bias is not None:
                part.bias.copy_(whole.bias)
        shards.append(part)
    w1 = shards[1].wq.to(x.dtype) if kind == "int8" else shards[1].weight
    other = TW._mm(x[:, h:], w1)
    shards[0].reduce = lambda y: y + other
    got = TW._linear(x[:, :h], shards[0])
    want = TW._linear(x, whole)
    assert got.dtype == want.dtype == torch.bfloat16
    assert (got == want).float().mean().item() >= 0.99


@pytest.fixture(scope="module")
def tp2_faults(np_params, tmp_path_factory):
    """Two tp = 2 meshes over gloo in bf16, two processes each: first_step
    on both, a fault every rank shares, then a fault planted on the
    follower alone in one and on the leader alone in the other."""
    tmp = tmp_path_factory.mktemp("faults")
    mels = np.random.default_rng(6).standard_normal((2, 512, DIMS.n_mels)).astype(np.float32)
    np.savez(tmp / "in.npz", params=np.asarray(np_params, dtype=object),
             dims=np.asarray(DIMS.__dict__, dtype=object),
             config=np.asarray({**NEVER, "compute_dtype": "bfloat16"}, dtype=object), mels=mels)
    (tmp / "faults.py").write_text(_FAULTS)
    runs = {f: _run(["faults.py", "in.npz", f"{f}.npz", f], tmp, f)
            for f in ("follower", "leader")}
    enc, logits = _port(np_params, compute_dtype="bfloat16").first_step(mels)
    out = {}
    for f, (proc, log) in runs.items():
        assert "LEADER_OK" in _finish(proc, log, tmp, f)
        out[f] = dict(np.load(tmp / f"{f}.npz"))
    return out, (enc.float().numpy(), logits.float().numpy())


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_tp2_bf16_rounds_once(tp2_faults):
    """A row-parallel layer sums its f32 partials over tp and rounds once,
    as the unsharded layer rounds its one product: the tp = 2 encoder
    states and first-step logits in bf16 stay within limits that rounding
    the partials to bf16 first exceeds (the readings above)."""
    got, (enc, logits) = tp2_faults
    for run in got.values():
        assert _rel_l2(run["enc"], enc) <= BF16_ENC_RTOL
        assert _rel_l2(run["logits"], logits) <= BF16_LOGITS_RTOL


@pytest.mark.parametrize("fault", ["shared", "follower", "leader"])
def test_rank_fault_fails_the_request(tp2_faults, fault):
    """A call that raises on every rank fails its request and the mesh goes
    on; one that raises on the follower alone, or on the leader alone,
    fails the leader's request within seconds (FAULT_GRACE and the
    process's end, where COMPUTE_TIMEOUT is minutes), the workers end and
    every later call raises at once."""
    got, _ = tp2_faults
    if fault == "shared":
        for run in got.values():
            assert "shapes cannot be multiplied" in str(run["shared"]), run["shared"]
            np.testing.assert_array_equal(run["enc_after"], run["enc"])
        return
    run = got[fault]
    assert "the serving mesh broke" in str(run["fault"]), run["fault"]
    assert float(run["fault_s"]) < TM.FAULT_GRACE.total_seconds() + 10
    assert "the serving mesh broke" in str(run["after"]) and float(run["after_s"]) < 1
    # the follower leaves its process; the leader kills one that waits
    assert list(run["exitcodes"]) == ([1] if fault == "follower" else [-signal.SIGKILL])


def test_watch_workers_breaks_the_mesh():
    """A local worker that ends before `stop_workers` breaks the leader's
    mesh with its exit code, whatever the leader waits in (an NCCL
    collective does not raise when its peer is gone), and the workers left
    are killed: they may wait in a collective for the leader."""
    import multiprocessing

    from speaksense_tpu_torch.parallel.workers import watch_workers

    ctx = multiprocessing.get_context("spawn")
    ends = ctx.Process(target=os._exit, args=(3,), name="ends")
    waits = ctx.Process(target=time.sleep, args=(60,), name="waits")
    waits.start()
    ends.start()
    mesh = TM.make_mesh(2, tp=2)                    # a layout: no process group
    watch_workers(mesh, [ends, waits])
    try:
        deadline = time.monotonic() + 10
        while mesh.broken is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert mesh.broken == "worker ends ended with exit code 3"
        waits.join(10)
        assert waits.exitcode == -signal.SIGKILL
        with pytest.raises(RuntimeError, match="the serving mesh broke"):
            mesh._check()
    finally:
        for p in (ends, waits):
            if p.is_alive():
                p.kill()
            p.join(5)


_HOST = textwrap.dedent("""
    import sys, numpy as np, torch
    torch.set_num_threads(1)
    from speaksense_tpu_torch.models import whisper as W
    from speaksense_tpu_torch.parallel import (init_distributed, local_serving_mesh,
                                               make_mesh, shard_params)

    z = np.load(sys.argv[1], allow_pickle=True)
    assert init_distributed()                      # from the SPEAKSENSE_* variables
    rank = torch.distributed.get_rank()
    local = local_serving_mesh(tp=1)               # this host's one rank
    assert local.devices.tolist() == [[rank]], local
    mesh = make_mesh()                             # the global (dp = 2, tp = 1) mesh
    assert mesh.devices.tolist() == [[0], [1]] and mesh.dp_index == rank
    model = W.params_from_jax(z["params"].item(), W.WhisperDims(**z["dims"].item()),
                              device="cpu", dtype=torch.float32)
    shard_params(model, mesh)
    mels = torch.from_numpy(z["mels"])
    half = mels.shape[0] // 2
    with mesh.on_path("window"):
        mine = W.encode(model, mels[rank * half:(rank + 1) * half], n_ctx_out=64)
        every = mesh.all_gather(mine, dim=0, axis="dp")
    if rank == 0:
        np.save(sys.argv[2], every.numpy())
    torch.distributed.destroy_process_group()
    print(f"HOST_OK rank={rank}")
""")


def test_two_hosts_dp_encode(np_params, tmp_path):
    """(d) two "hosts" of one rank each, brought up by init_distributed from
    the environment: each encodes its half of a batch of 4 windows on the
    global dp = 2 mesh and the gathered states equal a single-process
    encode (f32; the per-row products may block differently by batch size,
    so 1e-5 relative) and the JAX package's."""
    import jax.numpy as jnp

    from speaksense_tpu_torch.parallel.workers import free_port

    mels = np.random.default_rng(9).standard_normal((4, 128, DIMS.n_mels)).astype(np.float32)
    np.savez(tmp_path / "in.npz", params=np.asarray(np_params, dtype=object),
             dims=np.asarray(DIMS.__dict__, dtype=object), mels=mels)
    (tmp_path / "host.py").write_text(_HOST)
    coord = f"127.0.0.1:{free_port()}"
    procs = [_run(["host.py", "in.npz", "out.npy"], tmp_path, f"host{i}",
                  env={"SPEAKSENSE_COORDINATOR": coord, "SPEAKSENSE_NUM_PROCESSES": "2",
                       "SPEAKSENSE_PROCESS_ID": str(i)}) for i in range(2)]
    model = TW.params_from_jax(np_params, TDIMS, device="cpu", dtype=torch.float32)
    want = TW.encode(model, torch.from_numpy(mels), n_ctx_out=64).numpy()
    jwant = np.asarray(JW.encode(np_params, DIMS, jnp.asarray(mels), n_ctx_out=64))
    for i, (proc, log) in enumerate(procs):
        assert f"HOST_OK rank={i}" in _finish(proc, log, tmp_path, f"host{i}")
    got = np.load(tmp_path / "out.npy")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jwant, rtol=1e-4, atol=1e-4)


_SERVE = textwrap.dedent("""
    import asyncio, sys
    from speaksense_tpu_torch import main as M
    from speaksense_tpu_torch.config import EngineConfig

    if __name__ == "__main__":
        args = M.parse_args(sys.argv[1:])
        config = M.config_from_args(args)
        # f32, 16 tokens a window, the quality ladder neutralized
        config.engine = EngineConfig(compute_dtype="float32", max_decode_len=32,
                                     logprob_thold=-1e9, entropy_thold=-1.0,
                                     compression_ratio_thold=1e9)
        M.logsetup.init(config.log_dir)
        asyncio.run(M.serve(config, device=args.device))
""")


def test_serve_tp2_end_to_end(np_params, tmp_path):
    """(e) the port's server (`main.serve`, the flags of `python -m
    speaksense_tpu_torch.main`) with --tp 2 --device cpu on a tiny ggml
    file: it starts its second rank itself, answers one REST transcribe
    task, and a SIGTERM drains it and stops the worker."""
    from speaksense_tpu_torch.ckpt import ggml as TG
    from speaksense_tpu_torch.audio.io import write_wav
    from speaksense_tpu_torch.parallel.workers import free_port

    TG.write_ggml(TG.GgmlModel(dims=TDIMS, ftype=TG.F32, filters=np.zeros((0, 0), np.float32),
                               vocab=[b" w%d" % i for i in range(50257)],
                               tensors=TG.ggml_tensors_from_params(np_params, TDIMS)),
                  str(tmp_path / "tiny.bin"), ftype=TG.F32)
    t = np.arange(16000 * 3) / 16000
    write_wav(tmp_path / "in.wav", 0.3 * np.sin(2 * np.pi * 330 * t))
    http_port, grpc_port = free_port(), free_port()
    env = {"ASR_HTTP_PORT": str(http_port), "ASR_GRPC_PORT": str(grpc_port),
           "ETCD_ENDPOINT": "http://127.0.0.1:1", "ASR_SQLITE_PATH": f"sqlite://{tmp_path}/db",
           "ASR_AUDIO_PATH": str(tmp_path / "audio"),
           "ASR_MODEL_PATH": str(tmp_path / "tiny.bin")}
    (tmp_path / "serve.py").write_text(_SERVE)
    proc, log = _run(["serve.py", "--device", "cpu", "--tp", "2"], tmp_path, "server", env=env)
    base = f"http://127.0.0.1:{http_port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, (tmp_path / "server.log").read_text()
            assert time.monotonic() < deadline, (tmp_path / "server.log").read_text()
            try:
                with urllib.request.urlopen(f"{base}/health", timeout=1) as r:
                    assert json.load(r) == {"status": "ok"}
                break
            except OSError:
                time.sleep(0.2)
        text = (tmp_path / "server.log").read_text()
        admin = text.split("Generated initial admin API key: ")[1].split()[0]
        req = urllib.request.Request(
            f"{base}/asr/transcribe", method="POST",
            data=json.dumps({"path": str(tmp_path / "in.wav"), "path_type": "Local",
                             "callback_url": f"{base}/callback/http",
                             "language": "en"}).encode(),
            headers={"Authorization": f"Bearer {admin}", "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            task_id = json.load(r)["body"]
        while True:
            with urllib.request.urlopen(f"{base}/schedule/tasks/{task_id}", timeout=5) as r:
                task = json.load(r)["data"]
            if task["status"] in ("Completed", "Failed"):
                break
            assert time.monotonic() < deadline, task
            time.sleep(0.2)
        assert task["status"] == "Completed", task
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "server.log").read_text()
    assert "engine sharded over mesh [[0, 1]] (dp=1, tp=2), rank 0" in text, text[-3000:]
    assert "local workers stopped, exit codes [0]" in text, text[-3000:]
    assert "shutdown signal received; draining" in text, text[-3000:]
    assert "did not stop" not in text and "Traceback" not in text, text[-3000:]


BASE = JW.WhisperDims(n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=512,
                      n_audio_head=8, n_audio_layer=6, n_text_ctx=448, n_text_state=512,
                      n_text_head=8, n_text_layer=6)


@pytest.mark.slow
@pytest.mark.parametrize("layout", ["unsharded", "tp2"])
def test_base_dims_window_matches_jax(layout, tmp_path):
    """At real scale: whisper `base` widths and depth (d = 512, 8 heads,
    6 + 6 layers), random weights, one 30 s window, f32: the port's greedy
    tokens equal the JAX engine's and avg_logprob agrees to 1e-5, on one
    process and sharded tp = 2 over gloo."""
    np_params = JW.init_params_np(BASE, seed=3)
    mel = np.random.default_rng(4).standard_normal((1, 3000, BASE.n_mels)).astype(np.float32)
    want = JEngine(np_params, BASE, JTokenizer.synthetic(BASE.n_vocab),
                   config=JEngineConfig(**NEVER)).decode_windows(mel, "en", max_new_tokens=32)
    if layout == "unsharded":
        eng = TEngine.from_jax_params(np_params, TW.WhisperDims(**BASE.__dict__),
                                      Tokenizer.synthetic(BASE.n_vocab),
                                      config=EngineConfig(**NEVER), device="cpu")
        got = eng.decode_windows(mel, "en", max_new_tokens=32)
        _same(np.stack([g["tokens"] for g in got]), [g["n_sampled"] for g in got],
              [g["avg_logprob"] for g in got], want)
        return
    _save_inputs(tmp_path / "in.npz", np_params, BASE, mel, np.zeros((0,), np.float32))
    (tmp_path / "leader.py").write_text(_LEADER)
    proc, log = _run(["leader.py", "in.npz", "out.npz", "2", "1"], tmp_path, "leader")
    assert "LEADER_OK" in _finish(proc, log, tmp_path, "leader", timeout=600)
    got = dict(np.load(tmp_path / "out.npz"))
    _same(got["window_tokens"], got["window_n"], got["window_lp"], want)
