"""The PyTorch port stands alone.

``paddle_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor any
module of the JAX package (even those that do not import JAX): checked by
an AST scan, by importing every module of the port, and by serving a
Llama and a GPT request, taking Llama and ERNIE-MoE train steps (Llama
also in O2 with a GradScaler), running a masked ``nn.Transformer``, a
tensor-parallel Llama step, a request through a tensor-parallel
engine, sequence-parallel (ring and Ulysses), pipeline-parallel (GPipe
and 1F1B), expert-parallel ERNIE-MoE and tensor-parallel GPT steps, the
MoE dispatch collectives, the RNG tracker and every comm-efficient
strategy (``distributed/comm_opt.py``, ``fleet/comm_efficient.py``) on
two spawned ranks (and importing ``tools/torch_ep_train.py``), and
quantizing and
running a tiny Llama and both stochastic quantizers, taking BERT,
T5 (then ``generate``) and ViT steps, and deploying a Llama (``save_lm``
-> ``create_llm_predictor``) behind an ``EngineSupervisor`` and a
``ReplicaFleet`` through planted faults (and running
``tools/torch_chaos_serve.py``), and taking a supervised, checkpointed
train step through a NaN and an error, then resuming it in a second
process, in processes where importing either fails.
Entry points default to CUDA and raise when it is absent.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sources():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.extend(sorted((ROOT / "tools").glob("torch_*.py")))
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_jax_package_imports():
    bad = []
    for f in _sources():
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "paddle_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
    assert len(_sources()) > 10


def test_serves_a_request_with_jax_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["paddle_tpu"] = None
        import dataclasses
        import numpy as np
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.serving import Engine
        from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                        LlamaForCausalLM)
        pt.seed(0)
        m = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY,
                                                 dtype="float32"),
                             device="cpu")
        eng = Engine(m, n_slots=1, max_len=32, block_size=8,
                     flash_decode=True)
        out = eng.submit(np.arange(5), max_new_tokens=3).result()
        assert out.shape == (8,), out
        from paddle_tpu_torch.text.models import GPT_TINY, GPTForCausalLM
        gpt = GPTForCausalLM(GPT_TINY, device="cpu").eval()
        eng = Engine(gpt, n_slots=1, max_len=32, block_size=8,
                     flash_decode=True, prefill_chunk=8)
        out = eng.submit(np.arange(11), max_new_tokens=3).result()
        assert out.shape == (14,), out
        assert gpt.generate(np.arange(11)[None], max_new_tokens=3)[
            0].tolist() == out.tolist()
        assert not any(k == "jax" or k.startswith(("jax.", "paddle_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_trains_a_step_with_jax_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["paddle_tpu"] = None
        import dataclasses
        import numpy as np
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
        from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                        LlamaForCausalLM)
        pt.seed(0)
        cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                                  num_hidden_layers=1, fused_ce_chunk=256,
                                  remat="selective")
        m = fleet.distributed_model(LlamaForCausalLM(cfg, device="cpu"))
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=optimizer.lr.LinearWarmup(1e-3, 2, 0.0, 1e-3),
            parameters=m.parameters(), grad_clip=ClipGradByGlobalNorm(1.0)))
        step = opt.make_train_step(m, lambda mm, x, y: mm(x, labels=y))
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
        losses = [float(step(ids, ids)) for _ in range(3)]
        assert losses[2] < losses[0], losses
        # mixed precision: O2 after decorate, with a GradScaler
        from paddle_tpu_torch import amp, nn
        m2 = amp.decorate(LlamaForCausalLM(cfg, device="cpu"))
        step = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=1e-3, parameters=m2.parameters())
        ).make_train_step(m2, lambda mm, x, y: mm(x, labels=y),
                          amp_level="O2", scaler=amp.GradScaler())
        amp_losses = [float(step(ids, ids)) for _ in range(3)]
        assert amp_losses[2] < amp_losses[0], amp_losses
        # the Transformer layers, with a mask and attention dropout
        import torch
        t = nn.Transformer(32, 4, 1, 1, 64, device="cpu")
        out = t(torch.randn(2, 8, 32), torch.randn(2, 4, 32),
                tgt_mask=nn.Transformer.generate_square_subsequent_mask(4))
        assert out.shape == (2, 4, 32) and torch.isfinite(out).all()
        assert not any(k == "jax" or k.startswith(("jax.", "paddle_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_trains_ernie_moe_with_jax_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["paddle_tpu"] = None
        import dataclasses
        import numpy as np
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.text.models import (ERNIE_MOE_TINY,
                                                  ErnieMoEForPretraining)
        pt.seed(0)
        cfg = dataclasses.replace(ERNIE_MOE_TINY, num_hidden_layers=2)
        m = fleet.distributed_model(ErnieMoEForPretraining(cfg,
                                                           device="cpu"))
        for blk in m.ernie.blocks:
            if blk.use_moe:
                blk.moe.dispatch_mode = "sparse"
                blk.moe.expert_kernel = "ragged"
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=1e-3, parameters=m.parameters()))
        step = opt.make_train_step(m, lambda mm, x, y: mm(x, labels=y))
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
        losses = [float(step(ids, ids)) for _ in range(3)]
        assert losses[2] < losses[0], losses
        assert not any(k == "jax" or k.startswith(("jax.", "paddle_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_trains_bert_t5_and_vit_with_jax_unimportable():
    """BERT (MLM + NSP), T5 (labels, then ``generate``) and ViT take fleet
    + AdamW steps, and the HF converters load, in a process where
    importing JAX or the JAX package fails."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["paddle_tpu"] = None
        import dataclasses
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as pt
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.text.models import (BERT_TINY, T5_TINY,
                                                  BertForPretraining,
                                                  T5ForConditionalGeneration,
                                                  convert)
        from paddle_tpu_torch.vision import VisionTransformer

        def train(model, loss_fn, *batch):
            m = fleet.distributed_model(model)
            step = fleet.distributed_optimizer(optimizer.AdamW(
                learning_rate=1e-3, parameters=m.parameters())
            ).make_train_step(m, loss_fn)
            losses = [float(step(*batch)) for _ in range(3)]
            assert losses[2] < losses[0], losses
            return m

        pt.seed(0)
        rng = np.random.default_rng(0)
        cfg = dataclasses.replace(BERT_TINY, hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0)
        ids = rng.integers(0, cfg.vocab_size, (2, 16))
        mask = np.ones((2, 16), np.int64)
        mask[1, 10:] = 0
        train(BertForPretraining(cfg, device="cpu"),
              lambda m, x, k, y, n: m(x, attention_mask=k,
                                      masked_lm_labels=y,
                                      next_sentence_label=n),
              ids, mask, ids, np.array([0, 1]))
        src = rng.integers(2, 256, (2, 10))
        t5 = train(T5ForConditionalGeneration(T5_TINY, device="cpu"),
                   lambda m, x, y: m(x, labels=y), src, src[:, :6])
        out = t5.generate(src, max_new_tokens=4)
        assert out.shape == (2, 5) and (out[:, 0] == 0).all()
        vit = VisionTransformer(img_size=32, embed_dim=64, depth=1,
                                num_heads=2, num_classes=10, device="cpu")
        train(vit, lambda m, x, y: F.cross_entropy(m(x).float(), y),
              rng.standard_normal((2, 3, 32, 32)).astype(np.float32),
              np.array([1, 7]))
        hf = {"vit." + k: v for k, v in {
            "embeddings.cls_token": np.zeros((1, 1, 64), np.float32)}.items()}
        assert list(convert.convert_hf_vit_state_dict(hf)) == ["cls_token"]
        assert not any(k == "jax" or k.startswith(("jax.", "paddle_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_quantizes_a_model_with_jax_unimportable():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["paddle_tpu"] = None
        import dataclasses
        import numpy as np
        import torch
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.nn import quant
        from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                        LlamaForCausalLM)
        pt.seed(0)
        m = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY,
                                                 dtype="float32",
                                                 num_hidden_layers=1),
                             device="cpu")
        rng = np.random.default_rng(0)
        quant.PostTrainingQuantization(m).quantize(
            [rng.integers(0, 1024, (1, 16)) for _ in range(2)])
        assert isinstance(m.lm_head, quant.Int8Linear)
        with torch.inference_mode():
            logits = m(rng.integers(0, 1024, (1, 16)))
        assert torch.isfinite(logits).all() and logits.shape == (1, 16, 1024)
        w = torch.randn(8, 16)
        assert quant.stochastic_round(w, seed=1).dtype == torch.bfloat16
        q, s = quant.quantize_int8_stochastic(w, seed=2)
        assert q.dtype == torch.int8 and s.shape == (1, 1)
        assert not any(k == "jax" or k.startswith(("jax.", "paddle_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_every_module_imports_with_jax_unimportable():
    """Every module of the port, the distributed ones included."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["paddle_tpu"] = None
        import importlib, pkgutil
        import paddle_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        assert "paddle_tpu_torch.distributed.fleet.placement" in names
        assert "paddle_tpu_torch.distributed.collective_matmul" in names
        assert "paddle_tpu_torch.ops.pipeline" in names
        assert "paddle_tpu_torch.distributed.fleet.pp_train_step" in names
        assert "paddle_tpu_torch.text.models.llama_pipe" in names
        assert "paddle_tpu_torch.distributed.utils" in names
        assert "paddle_tpu_torch.distributed.fleet.meta_parallel.random" \
            in names
        for n in ("amp.auto_cast", "amp.grad_scaler", "tensor_ops.math",
                  "nn.layer.transformer",
                  "distributed.fleet.meta_optimizers",
                  "nn.layer.activation", "nn.layer.conv",
                  "nn.functional.conv", "text.models.bert",
                  "text.models.t5", "text.models.convert",
                  "vision.models.vit", "jit", "jit.serialization",
                  "inference", "resilience", "resilience.chaos",
                  "resilience.ledger", "resilience.supervisor",
                  "serving.resilience", "serving.fleet",
                  "framework.trace_id", "framework.attempt",
                  "utils", "utils.watchdog", "distributed.checkpoint",
                  "distributed.elastic", "io", "io.dataset", "io.sampler",
                  "io.dataloader"):
            assert "paddle_tpu_torch." + n in names, n
        sys.path.insert(0, "tools")
        importlib.import_module("torch_ep_train")
        importlib.import_module("torch_chaos_serve")
        importlib.import_module("torch_chaos_train")
        assert not any(k == "jax" or k.startswith(("jax.", "paddle_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("OK", len(names))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr


def test_supervised_checkpointed_resumed_step_with_jax_unimportable(
        tmp_path):
    """A fleet train step on a DataLoader under a Supervisor with a
    CheckpointManager, through a NaN and a retried error, then a fresh
    process's step resumed from the checkpoint: the same losses."""
    code = textwrap.dedent("""
        import sys, json
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["paddle_tpu"] = None
        import dataclasses
        import numpy as np
        import paddle_tpu_torch as pt
        pt.set_device("cpu")
        from paddle_tpu_torch import optimizer
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.checkpoint import (
            CheckpointManager)
        from paddle_tpu_torch.io import (DataLoader, DistributedBatchSampler,
                                         TensorDataset)
        from paddle_tpu_torch.resilience import (ChaosMonkey,
                                                 ResumableLoader, Supervisor,
                                                 TrainState)
        from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                        LlamaForCausalLM)
        pt.seed(0)
        cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                                  num_hidden_layers=1)
        m = fleet.distributed_model(LlamaForCausalLM(cfg))
        step = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=1e-3, parameters=m.parameters())
        ).make_train_step(m, lambda mm, x: mm(x, labels=x))
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16))
        loader = ResumableLoader(DataLoader(
            TensorDataset([ids]), batch_sampler=DistributedBatchSampler(
                ids, 2, num_replicas=1, rank=0, shuffle=True)), epochs=2)
        mgr = CheckpointManager(sys.argv[1])
        fn = step
        if sys.argv[2] == "first":
            fn = ChaosMonkey(at={1: "nan", 2: "error"}).wrap(step)
        sup = Supervisor(fn, TrainState(train_step=step, loader=loader),
                         manager=mgr, save_interval=3, retry_backoff_s=0.0)
        start, losses = sup.resume(), []
        for (x,) in loader:
            out = sup.step(x)
            losses.append(None if out is None else float(out))
        sup.close()
        print(json.dumps({"start": start, "losses": losses,
                          "stats": sup.stats()}))
        assert not any(k == "jax" or k.startswith(("jax.", "paddle_tpu."))
                       for k, v in sys.modules.items() if v is not None)
    """)
    outs = []
    for mode in ("first", "resumed"):
        r = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                            mode], cwd=ROOT, capture_output=True, text=True,
                           timeout=120,
                           env={**os.environ, "PYTHONPATH": str(ROOT)})
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    first, resumed = outs
    assert first["start"] == 0 and len(first["losses"]) == 8
    assert first["losses"][1] is None           # the NaN step is skipped
    assert first["stats"]["retries"] == 1 and first["stats"]["skipped"] == 1
    assert all(np.isfinite(v) for v in first["losses"] if v is not None)
    # the second process resumes after the last cadence save (step 5) at
    # step 6, two batches from the end of epoch 2: the same two losses
    assert resumed["start"] == 6
    assert resumed["losses"] == first["losses"][6:]


def test_deploys_and_supervises_with_jax_unimportable(tmp_path):
    """``save_lm`` -> ``create_llm_predictor``, an ``EngineSupervisor``
    through a decode-raise and a kv-corrupt, a ``ReplicaFleet`` through a
    replica kill, and ``tools/torch_chaos_serve.py``, all on the CPU in a
    process where importing JAX or the JAX package fails."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["paddle_tpu"] = None
        import dataclasses
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.inference import create_llm_predictor
        from paddle_tpu_torch.resilience import ChaosMonkey
        from paddle_tpu_torch.serving import (Engine, EngineSupervisor,
                                              ReplicaFleet, save_lm)
        from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                        LlamaForCausalLM)
        pt.seed(0)
        m = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY,
                                                 dtype="float32",
                                                 num_hidden_layers=1),
                             device="cpu").eval()
        kw = dict(n_slots=2, max_len=32, block_size=8, flash_decode=True)
        ps = [np.arange(5) + 3 * i for i in range(3)]

        def run(server):
            hs = [server.submit(p, max_new_tokens=6) for p in ps]
            while any(not h.finished for h in hs):
                server.step()
            return [list(h.tokens) for h in hs]

        want = run(Engine(m, **kw))
        pred = create_llm_predictor(save_lm(m, {str(tmp_path / "lm")!r}),
                                    device="cpu", **kw)
        assert run(pred.engine) == want
        for fault in ("decode-raise", "kv-corrupt"):
            sup = EngineSupervisor(m, chaos=ChaosMonkey(at={{2: fault}}),
                                   kv_probe_interval=1, **kw)
            assert run(sup) == want and sup.rebuilds == 1, fault
        fleet = ReplicaFleet(m, 2, chaos=ChaosMonkey(
            at={{2: "replica-kill"}}), **kw)
        assert run(fleet) == want and fleet.migrations >= 1
        sys.path.insert(0, "tools")
        import torch_chaos_serve
        assert torch_chaos_serve.main(["--fleet", "2", "--fault", "kill",
                                       "--device", "cpu"]) == 0
        assert not any(k == "jax" or k.startswith(("jax.", "paddle_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0 and r.stdout.strip().endswith("OK"), r.stderr


def test_hybrid_step_on_two_ranks_with_jax_unimportable(tmp_path):
    """A tp2 Llama step, a request through a tp2 ``Engine``, sep2 ring
    and Ulysses steps, pp2 GPipe and 1F1B steps, ERNIE-MoE mp2 and GPT
    tp2 steps, a step pair under each comm-efficient strategy (comm_opt,
    fp16_allreduce, localsgd, a_sync, dgc) at dp2, a dispatch round trip
    and the RNG tracker over gloo in two spawned ranks, each of which
    makes JAX and the JAX package unimportable first."""
    import pickle

    import torch_dist_worker as W
    from paddle_tpu_torch import distributed as dist
    dist.spawn(W.isolation_worker, args=(str(tmp_path),), nprocs=2,
               timeout=120)
    outs = []
    for r in range(2):
        with open(tmp_path / f"isolation.r{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    assert outs[0]["losses"] == outs[1]["losses"]
    assert outs[0]["losses"][1] < outs[0]["losses"][0]
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert len(outs[0]["tokens"]) == 5 + 3
    for mode in ("ring", "ulysses"):
        assert outs[0]["sep_losses"][mode] == outs[1]["sep_losses"][mode]
        assert outs[0]["sep_losses"][mode][1] < \
            outs[0]["sep_losses"][mode][0]
    for schedule in ("gpipe", "1f1b"):
        assert outs[0]["pp_losses"][schedule] == \
            outs[1]["pp_losses"][schedule]
        assert outs[0]["pp_losses"][schedule][1] < \
            outs[0]["pp_losses"][schedule][0]
    for model in ("ernie_moe", "gpt"):
        assert outs[0]["tp_losses"][model] == outs[1]["tp_losses"][model]
        assert outs[0]["tp_losses"][model][1] < \
            outs[0]["tp_losses"][model][0]
    for field in ("comm_opt", "fp16_allreduce", "localsgd", "a_sync", "dgc"):
        assert outs[0]["comm_losses"][field] == \
            outs[1]["comm_losses"][field]
        assert outs[0]["comm_losses"][field][1] < \
            outs[0]["comm_losses"][field][0]
    for r in range(2):
        assert (outs[r]["dispatched"] == 1).all()
        assert outs[r]["tracker_seeds"] == [3 * 1024 + r * 100]
    assert not outs[0]["loaded"] and not outs[1]["loaded"]


def test_default_device_is_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from paddle_tpu_torch.framework.device import (get_device,
                                                   resolve_device)
    from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                    LlamaForCausalLM)
    assert get_device() == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(LLAMA_TINY)
    from paddle_tpu_torch.text.models import (BERT_TINY, T5_TINY,
                                              BertForPretraining,
                                              BertForSequenceClassification,
                                              T5ForConditionalGeneration)
    from paddle_tpu_torch.vision import vit_s_16
    for make in (lambda: BertForPretraining(BERT_TINY),
                 lambda: BertForSequenceClassification(BERT_TINY),
                 lambda: T5ForConditionalGeneration(T5_TINY),
                 lambda: vit_s_16(img_size=32)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("gpu:0")
    assert resolve_device("cpu") == torch.device("cpu")
    # the deployment path: the predictor rebuilds its model on the card
    # unless told otherwise; the supervisor and the fleet serve on their
    # model's device, the card by default
    import dataclasses
    from paddle_tpu_torch.inference import create_llm_predictor
    from paddle_tpu_torch.serving import (EngineSupervisor, ReplicaFleet,
                                          save_lm)
    cpu = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY,
                                               num_hidden_layers=1),
                           device="cpu")
    path = save_lm(cpu, str(tmp_path / "lm"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_llm_predictor(path)
    assert create_llm_predictor(path, device="cpu",
                                n_slots=1).engine.device.type == "cpu"
    for wrap in (EngineSupervisor, ReplicaFleet):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wrap(LlamaForCausalLM(LLAMA_TINY))
    assert EngineSupervisor(cpu, n_slots=1).engine.device.type == "cpu"
    assert ReplicaFleet(cpu, 2, n_slots=1).replicas[
        "r1"].engine.device.type == "cpu"
    # training robustness: the loader, template-free checkpoint loads and
    # the chaos tool run on the card unless asked for the CPU
    from paddle_tpu_torch.distributed.checkpoint import (load_distributed,
                                                         save_distributed)
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataLoader(TensorDataset([np.zeros((4, 2))]), batch_size=2)
    path = save_distributed({"w": torch.ones(2)}, str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_distributed(path)
    r = subprocess.run([sys.executable, "tools/torch_chaos_train.py",
                        "--workdir", str(tmp_path / "chaos")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_set_device_cpu_switches_the_default():
    import paddle_tpu_torch as pt
    before = pt.get_device()
    try:
        assert pt.set_device("cpu") == "cpu"
        from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                        LlamaForCausalLM)
        import dataclasses
        m = LlamaForCausalLM(dataclasses.replace(LLAMA_TINY,
                                                 num_hidden_layers=1))
        assert m.device.type == "cpu"
        assert m.lm_head.weight.dtype == torch.bfloat16
    finally:
        # restore without resolving: "cuda" may be absent here
        import paddle_tpu_torch.framework.device as d
        d._current_device = before
