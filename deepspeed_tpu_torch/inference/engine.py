"""InferenceEngine — generation on one device (port of
``deepspeed_tpu/inference/engine.py``).

What carries over: the engine-owned KV-cache workspace, one-pass and
split (chunked) prefill with the same ``"auto"`` chunk policy and
``prefill_plan`` answers, right-padded ``attention_mask`` prompts,
greedy / temperature / top-k / top-p sampling over fp32 logits, and the
``decode_early_exit`` semantics (steps after a row's eos emit eos; the loop
stops once every row is done), and ``serve()``: continuous batching over
slot lanes or a paged KV pool (``inference/serving``).  With
``quant.enabled`` the weights are quantized when they are set, from their
fp32 values (the JAX ``set_params`` quantizes before its cast to the
compute dtype), and stay resident as int8 / packed int4; an int8-KV model
(``kv_cache_quant``) gets int8 workspaces with their scales.

**Compiled decode programs.**  The JAX engine runs ``generate()`` as one
compiled program per signature: prefill, then a bounded ``while_loop``
that stops on the device once every row is done.  Here, with
``enable_cuda_graph`` (on by default, as in JAX), the decode loop is a
CUDA graph of :data:`DECODE_STEPS_PER_GRAPH` decode steps (sample, eos
mask and ``done`` update on the device), captured once per signature by a
:class:`~deepspeed_tpu_torch.model_implementations.CompiledGraphModule`
and replayed ``ceil(T / k)`` times, with a tail graph for ``T mod k``
steps; ``done`` is read once per replay.  The prefill stays eager (see
:class:`CapturedGenerate`).  The graphs are tied to the KV-cache
workspace's buffers and are dropped when it grows or is released.
:meth:`InferenceEngine.warmup` captures them ahead of time.
``enable_cuda_graph=False`` keeps the eager per-step loop; an engine on
the CPU runs the same decode programs directly (no graph there).

**Tensor parallelism.**  With ``tensor_parallel.tp_size`` > 1 (a live
process group of tp ranks or more) the model is split as the JAX engine
places it (``DEFAULT_TP_RULES``, ``parallel/tensor_parallel.py``): each
rank holds its heads, ffn columns and vocabulary rows, its KV cache holds
its kv heads, and the logits are gathered before sampling, so every rank
draws the same tokens from its identically seeded generator.  ``set_params``
/ ``load_checkpoint`` take global weights and keep each rank's slices;
``init_params`` draws the world-size-1 init and cuts it.  Quantized weights
at tp > 1 stay whole on every rank, as in JAX (a warning).  The captured
decode graphs capture the collectives; ``serve()`` at tp > 1 runs one
schedule on every rank, rank 0's (``inference/serving/tp_schedule.py``).

What has no counterpart here: the JAX engine's persistent executable
cache, its compiled-program memory guard and the ``_run_guarded``
retries.  Cache updates happen in place instead of by donation.
"""

import time
import weakref
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.inference.config import (DeepSpeedInferenceConfig,
                                                  normalize_dtype_str)
from deepspeed_tpu_torch.model_implementations.features.cuda_graph import (
    CompiledGraphModule)
from deepspeed_tpu_torch.runtime.weight_quantizer import (WeightQuantization,
                                                          holds_quantized)
from deepspeed_tpu_torch.utils.logging import log_dist, warning_once

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

# decode steps in one captured decode graph (k): ``done`` is read once per
# replay, and up to k - 1 steps run after every row is done; chosen on the
# card from 4 and 16 by scripts/decode_graph_steps.py (PERF.md)
DECODE_STEPS_PER_GRAPH = 4


class InferenceEngine:

    def __init__(self, model, config=None, device=None):
        """``model``: a port ``Transformer``.  ``device``: where the engine
        runs — ``None`` means ``"cuda"`` and raises without a card; pass
        ``"cpu"`` for the plain PyTorch path.  Weights come from
        ``set_params`` or ``init_params`` unless the model already holds
        them (it was built on a real device)."""
        self.device = resolve_device(device)
        self._accel = get_accelerator(self.device)
        self._config = config or DeepSpeedInferenceConfig()
        self.compute_dtype = _DTYPES[normalize_dtype_str(self._config.dtype)]
        q = self._config.quant
        self._quantizer = None if not q.enabled else WeightQuantization(
            bits=q.bits, group_size=q.group_size, per_channel=q.per_channel)
        # a quantizing engine holds fp32 weights until they are quantized
        dtype = torch.float32 if self._quantizer else self.compute_dtype
        self._init_tensor_parallel(model)
        on_meta = any(p.is_meta for p in model.parameters())
        if on_meta:
            # cast on meta (free), then allocate once on the device
            self.module = model.to(dtype=dtype).to_empty(device=self.device)
        elif holds_quantized(model):
            # already quantized (another engine's module): keep its payloads
            # and scales as they are
            self.module = model.to(device=self.device)
        else:
            self.module = model.to(device=self.device, dtype=dtype)
            if self._quantizer:
                self._quantize()
        self.module.eval()
        self._has_params = not on_meta
        # the generation programs, one per signature (the JAX memo)
        self._programs = {}
        self._workspace = KVCacheWorkspace(self.module,
                                           on_drop=self._drop_graphs)
        # reseeded in place, never rebound: captured graphs draw from it
        self._gen = self._accel.manual_seed(0, self.device)
        log_dist(f"inference engine on {self._accel.device_name(self.device)}"
                 f", dtype={self.compute_dtype}", ranks=[0])
        if self._config.checkpoint is not None:
            self.load_checkpoint(self._config.checkpoint)

    def _init_tensor_parallel(self, model):
        """At ``tensor_parallel.tp_size`` > 1: the topology of the live
        world and ``model`` cut to this tp rank (on ``meta``: the local
        shapes; with weights: the slices), unless the weights are to be
        quantized (JAX keeps them whole on every rank)."""
        from deepspeed_tpu_torch import comm
        self.topology, self._tp, self._tp_plan = None, None, None
        tp = int(self._config.tensor_parallel.tp_size or 1)
        if tp == 1:
            return
        if not comm.is_initialized():
            raise ValueError(
                f"tensor parallelism (tp {tp}) needs a process group of tp "
                f"ranks or more: start the ranks with python -m "
                f"deepspeed_tpu_torch.launcher.runner and call "
                f"init_distributed() first")
        from deepspeed_tpu_torch.parallel import topology as topo_mod
        from deepspeed_tpu_torch.parallel.tensor_parallel import (
            TensorParallel, shard_module_)
        topo = topo_mod._TOPOLOGY
        if topo is None or topo.groups is None or topo.tp != tp or \
                topo.world_size != comm.get_world_size():
            topo = topo_mod.initialize_topology(tp=tp)
        self.topology = topo
        if self._quantizer is not None:
            warning_once("weight quantization with tp>1: quantized "
                         "payloads are replicated, not TP-sharded")
            return
        self._tp = TensorParallel.from_topology(topo)
        self._tp_plan = shard_module_(model, self._tp)

    # ------------------------------------------------------------------ #
    # Weights
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def set_params(self, params):
        """Load a float ``state_dict`` (torch tensors or numpy arrays, e.g.
        from ``params_from_flax``); floating tensors are cast to the compute
        dtype, as the JAX engine casts its parameter tree — or, with
        ``quant.enabled``, loaded in fp32 and quantized first."""
        sd = {k: v if isinstance(v, torch.Tensor)
              else torch.tensor(np.asarray(v)) for k, v in params.items()}
        dtype = torch.float32 if self._quantizer else self.compute_dtype
        sd = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in sd.items()}
        if self._tp_plan is not None:
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                slice_state_dict)
            sd = slice_state_dict(sd, self._tp_plan)
        self._float_layout()
        self.module.load_state_dict(sd, strict=True)
        self._has_params = True
        n = sum(p.numel() for p in self.module.parameters())
        log_dist(f"inference params placed: {n / 1e6:.1f}M, "
                 f"dtype={dtype}", ranks=[0])
        if self._quantizer:
            self._quantize()

    def load_checkpoint(self, path, tag=None):
        """Weights from a checkpoint, then :meth:`set_params` (int8
        quantization included with ``quant.enabled``).

        * A directory: a training checkpoint's tag (``latest``'s when
          ``tag`` is None) — its ``module`` group.
        * A file: a ``save_16bit_model`` export with flax-path keys — a
          ``.safetensors`` file, or a torch state dict read with
          ``weights_only=True``.  A file that needs full (code-executing)
          unpickling — a legacy pickled parameter tree, a torch file with
          other objects — loads only with
          ``DSTPU_ALLOW_PICKLE_CHECKPOINTS=1``, as in the JAX package.
          HF-named exports (``hf_policy``) raise, as in JAX: they load
          through ``module_inject.convert_hf_model``.
        * A Megatron-LM GPT checkpoint: a DeepSpeed checkpoint-description
          json (a ``.json`` path, or its dict with ``checkpoints``), read
          with this model's config (:meth:`_megatron_params`).  At tp > 1
          every rank merges the shard files and keeps its slice."""
        import os
        if isinstance(path, Mapping) or str(path).endswith(".json"):
            self.set_params(self._megatron_params(path))
            return
        path = str(path)
        if os.path.isfile(path):
            self.set_params(self._params_from_file(path))
            return
        from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine \
            import TorchCheckpointEngine
        from deepspeed_tpu_torch.runtime.fault.manifest import read_latest
        tag = tag or read_latest(path)
        state_path = os.path.join(path, str(tag), "state") if tag else path
        arrays, _ = TorchCheckpointEngine().load(state_path,
                                                 groups=("module",))
        if not arrays or arrays.get("module") is None:
            from deepspeed_tpu_torch.runtime.fault.manifest import \
                CheckpointCorrupt
            raise CheckpointCorrupt(f"{state_path}: no 'module' arrays to "
                                    "load")
        self.set_params(arrays["module"])

    def _megatron_params(self, description):
        """The global ``state_dict`` of a Megatron-LM GPT checkpoint named
        by a description json, mapped by ``MegatronGPTPolicy`` onto this
        engine's model config (the fused QKV's layout by the
        description's ``version``, v2 when it names none)."""
        from deepspeed_tpu_torch.models.transformer import params_from_flax
        from deepspeed_tpu_torch.module_inject.containers import (
            MegatronGPTPolicy)
        from deepspeed_tpu_torch.module_inject.replace_module import (
            merged_megatron_state)
        sd, version = merged_megatron_state(
            dict(description) if isinstance(description, Mapping)
            else description)
        policy = MegatronGPTPolicy()
        policy.megatron_v2 = float(version) >= 2.0
        cfg = self.module.config
        return params_from_flax(policy.convert(sd, cfg), cfg)

    def _params_from_file(self, path):
        """A ``state_dict`` of this model from an export file (flax-path
        keys) or a pickled parameter tree."""
        import os
        import pickle
        from deepspeed_tpu_torch.models.transformer import params_from_flax
        cfg = self.module.config
        if path.endswith(".safetensors"):
            from deepspeed_tpu_torch.checkpoint.safetensors_io import load_file
            return params_from_flax(_flax_flat(load_file(path)), cfg)
        try:
            # weights_only: never execute pickled code while probing
            tree = torch.load(path, map_location="cpu", weights_only=True)
        except (pickle.UnpicklingError, RuntimeError):
            if os.environ.get("DSTPU_ALLOW_PICKLE_CHECKPOINTS") != "1":
                raise ValueError(
                    f"{path}: not loadable with weights_only unpickling; "
                    "full pickle execution is disabled for untrusted files. "
                    "Set DSTPU_ALLOW_PICKLE_CHECKPOINTS=1 to load a legacy "
                    "pickled parameter tree (or a torch file with "
                    "non-allowlisted objects) you trust.") from None
            try:                         # torch file with other objects
                tree = torch.load(path, map_location="cpu",
                                  weights_only=False)
            except RuntimeError:         # a bare pickle stream
                with open(path, "rb") as f:
                    tree = pickle.load(f)
        if not any(isinstance(v, Mapping) for v in tree.values()):
            tree = _flax_flat(tree)            # flat flax-path keys
        return params_from_flax(tree, cfg)

    def init_params(self, seed=0):
        """Random init from a ``torch.Generator`` seeded with ``seed``
        (testing / benchmarking without a checkpoint); fp32 and then
        quantized with ``quant.enabled``."""
        gen = self._accel.manual_seed(seed, self.device)
        self._float_layout()
        if self._tp_plan is not None:
            from deepspeed_tpu_torch.parallel.tensor_parallel import (
                init_sharded_)
            init_sharded_(self.module, self._tp_plan, gen)
        else:
            self.module.init_weights(gen)
        self._has_params = True
        if self._quantizer:
            self._quantize()

    def _float_layout(self):
        """Back to float linear layers before new weights: a quantizing
        engine's in fp32, any other's in the compute dtype."""
        if holds_quantized(self.module):
            self.module.float_weights_()
            if not self._quantizer:
                self.module.to(dtype=self.compute_dtype)

    def _quantize(self):
        self.module.quantize_weights_(self._quantizer, self.compute_dtype)
        q = self._quantizer
        log_dist(f"inference weights quantized to int{q.bits} "
                 f"({'per channel' if q.per_channel else f'group {q.group_size}'}"
                 f"), the rest in {self.compute_dtype}", ranks=[0])

    def _require_params(self):
        if not self._has_params:
            raise RuntimeError("no parameters: set_params/init_params first")

    def _ids(self, input_ids):
        if not isinstance(input_ids, torch.Tensor):
            input_ids = torch.tensor(np.asarray(input_ids))
        return input_ids.to(self.device, torch.long)

    # ------------------------------------------------------------------ #
    # Forward / generation
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None, **kwargs):
        """Full logits; ``attention_mask`` masks padded positions."""
        self._require_params()
        if kwargs:
            raise TypeError(f"unsupported forward arguments: {sorted(kwargs)}")
        mask = None if attention_mask is None else self._ids(attention_mask)
        return self.module.logits(self._ids(input_ids), mask)

    __call__ = forward

    def _get_generate(self, prompt_len, max_new_tokens, do_sample,
                      temperature, top_k, top_p, with_mask=False,
                      external_prefill=False):
        """The generation program of a signature, memoized as the JAX
        engine memoizes its compiled programs: captured decode graphs with
        ``enable_cuda_graph``, else the eager loop."""
        key = (prompt_len, max_new_tokens, do_sample, temperature, top_k,
               top_p, with_mask, external_prefill)
        fn = self._programs.get(key)
        if fn is None:
            fn = make_generate_fn(
                self.module, prompt_len, max_new_tokens, do_sample,
                temperature, top_k, top_p, with_mask=with_mask,
                external_prefill=external_prefill,
                early_exit=self._config.decode_early_exit,
                graphs=self._config.enable_cuda_graph)
            self._programs[key] = fn
        return fn

    def _drop_graphs(self):
        """Drop every captured decode graph: the workspace buffers they
        were captured on are about to be freed."""
        for fn in self._programs.values():
            if isinstance(fn, CapturedGenerate):
                fn.reset()

    def _prefill_chunk_for(self, batch_size, prompt_len):
        cfg = self._config.prefill_chunk_size
        if cfg in (None, 0, "none", "off"):
            return None
        if cfg == "auto":
            return default_prefill_chunk(batch_size, prompt_len)
        # user-specified chunk: round up to a multiple of 8, floor 8, cap
        # 512 (the chunk kernel's longest block), as the JAX engine does
        c = min(512, max(8, -(-int(cfg) // 8) * 8))
        if c != int(cfg):
            warning_once(f"prefill_chunk_size={cfg} adjusted to {c} "
                         f"(multiple of 8, min 8, max 512)")
        return c if c < prompt_len else None

    def prefill_plan(self, batch_size, prompt_len, paged=False):
        """Which prefill pipeline ``generate(batch, prompt)`` takes, as
        ``(mode, chunk, reason)``: ``("chunked", C, ...)`` for the split
        per-chunk path, ``("one_pass", None, ...)`` otherwise.  The reason
        ends with the attention-registry modes the run dispatches through:
        with ``paged=True``, those of a paged serving pool (K7 prefill
        chunks, K6 decode)."""
        from deepspeed_tpu_torch.ops.transformer.registry import kernel_modes
        modes = kernel_modes(paged=bool(paged))
        tail = (" [kernels: prefill=%s decode=%s]"
                % (modes["prefill_chunk"], modes["decode"]))
        cfg = self._config.prefill_chunk_size
        chunk = self._prefill_chunk_for(int(batch_size), int(prompt_len))
        if chunk is not None and chunk < prompt_len:
            why = "explicit prefill_chunk_size" \
                if cfg != "auto" else "auto policy accepted"
            return "chunked", chunk, why + tail
        if cfg in (None, 0, "none", "off"):
            return "one_pass", None, "chunking disabled by config" + tail
        if cfg == "auto":
            return ("one_pass", None,
                    "auto policy declined: working set under "
                    "DSTPU_PREFILL_TOKEN_BUDGET" + tail)
        return "one_pass", None, "chunk >= prompt_len" + tail

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=-1,
                 seed=None, attention_mask=None):
        """Autoregressive generation: returns [B, prompt_len +
        max_new_tokens] (long) — prompt followed by new tokens.

        ``attention_mask`` supports RIGHT-padded prompts (1 = real token):
        each row continues from its own prompt length; generated tokens
        occupy the trailing ``max_new_tokens`` columns."""
        self._require_params()
        input_ids = self._ids(input_ids)
        if attention_mask is not None:
            require_right_padded(attention_mask)
            attention_mask = self._ids(attention_mask)
        if seed is not None:
            self._gen.manual_seed(int(seed))
        try:
            return self._generate_once(input_ids, int(max_new_tokens),
                                       bool(do_sample), float(temperature),
                                       int(top_k), float(top_p),
                                       int(eos_token_id), attention_mask)
        except RuntimeError as e:
            if self._tp is not None and self._config.enable_cuda_graph and \
                    self.device.type == "cuda" and "captur" in str(e).lower():
                raise RuntimeError(
                    f"enable_cuda_graph at tensor-parallel size "
                    f"{self._tp.size}: capturing the decode graph's "
                    f"collectives failed ({e}); set enable_cuda_graph="
                    f"False for the eager loop") from e
            raise

    def _generate_once(self, input_ids, max_new_tokens, do_sample,
                       temperature, top_k, top_p, eos_token_id,
                       attention_mask, timings=None):
        B, P = input_ids.shape
        chunk = self._prefill_chunk_for(B, P)
        n_chunks = -(-P // chunk) if chunk else 1
        if n_chunks > 1:
            return self._generate_split(input_ids, max_new_tokens, do_sample,
                                        temperature, top_k, top_p,
                                        eos_token_id, attention_mask, chunk,
                                        timings)
        fn = self._get_generate(P, max_new_tokens, do_sample, temperature,
                                top_k, top_p,
                                with_mask=attention_mask is not None)
        cache = self._workspace.take(
            B, required_cache_len(P, max_new_tokens, chunk),
            self.compute_dtype)
        out, _ = fn(cache, input_ids, self._gen, eos_token_id,
                    attention_mask)
        return out

    def _generate_split(self, input_ids, max_new_tokens, do_sample,
                        temperature, top_k, top_p, eos_token_id,
                        attention_mask, chunk, timings=None):
        """Split-prefill generation: the prompt goes through the model in
        ``chunk``-token blocks, each attending to the cache through the
        chunk kernel (chunk 0 included), then the decode-only loop."""
        B, P = input_ids.shape
        C = int(chunk)
        n = -(-P // C)
        cache = self._workspace.take(
            B, required_cache_len(P, max_new_tokens, C), self.compute_dtype)
        ids_pad = F.pad(input_ids, (0, n * C - P))
        if attention_mask is not None:
            last = attention_mask.long().sum(1) - 1
        else:
            last = torch.full((B,), P - 1, dtype=torch.long,
                              device=self.device)
        sel = None
        for ci in range(n):
            local = (last - ci * C).clamp(0, C - 1)
            logits, cache = self.module.decode(
                ids_pad[:, ci * C:(ci + 1) * C], cache, ci * C,
                logits_at=local)
            in_chunk = ((last // C) == ci)[:, None, None]
            sel = logits if sel is None \
                else torch.where(in_chunk, logits, sel)
        if timings is not None:
            self._accel.synchronize(self.device)
            timings["prefill"] = time.perf_counter()
        fn = self._get_generate(P, max_new_tokens, do_sample, temperature,
                                top_k, top_p,
                                with_mask=attention_mask is not None,
                                external_prefill=True)
        out, _ = fn(cache, input_ids, self._gen, eos_token_id,
                    attention_mask, sel)
        return out

    def release_workspace(self):
        """Free the persistent KV-cache workspace buffer (and the decode
        graphs captured on it)."""
        self._workspace.release()

    # ------------------------------------------------------------------ #
    # Warmup: capture every decode graph up front
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def warmup(self, prompt_len, max_new_tokens, batch_sizes=(1,),
               do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
               with_mask=False):
        """Capture every program a ``generate(prompt_len, max_new_tokens)``
        call will run, for each batch size in ``batch_sizes`` — the
        split-prefill pair when the chunk policy routes that batch there.
        Returns ``{program: seconds}`` under the JAX engine's names:
        ``generate:b{B}p{P}n{N}``, or ``prefill_chunk:b{B}c{C}`` and
        ``decode:b{B}p{P}n{N}``; 0.0 where the program was captured
        already.

        Unlike the JAX engine's abstract AOT compile, a capture runs: each
        batch size makes one ``generate()`` call on an all-zero prompt
        (no eos, no early exit), on the real KV workspace, which is first
        sized for the largest batch size so that no later size drops the
        graphs of an earlier one.  That is harmless: every attention path
        masks the stale cache rows it leaves behind, and the engine's
        generator is restored afterwards, so later draws are unchanged.
        The prefill (and a chunked prefill's chunks) runs eagerly and has
        no graph: its seconds are its first run's.  With
        ``enable_cuda_graph=False`` nothing is captured and every name
        reports 0.0; on the CPU the call runs once all the same."""
        self._require_params()
        P, new = int(prompt_len), int(max_new_tokens)
        sizes = [int(b) for b in batch_sizes]
        top = max(sizes)
        self._workspace.take(top, required_cache_len(
            P, new, self._prefill_chunk_for(top, P)), self.compute_dtype)
        state = self._gen.get_state()
        report = {}
        try:
            for B in sizes:
                report.update(self._warmup_one(
                    B, P, new, bool(do_sample), float(temperature),
                    int(top_k), float(top_p), bool(with_mask)))
        finally:
            self._gen.set_state(state)
        for name, dt in report.items():
            log_dist(f"warmup[{name}]: "
                     + ("captured" if dt == 0.0 else f"{dt:.3f}s"),
                     ranks=[0])
        return report

    precompile = warmup

    def _warmup_one(self, B, P, new, do_sample, temperature, top_k, top_p,
                    with_mask):
        chunk = self._prefill_chunk_for(B, P)
        split = chunk is not None and -(-P // chunk) > 1
        if split:
            names = (f"prefill_chunk:b{B}c{chunk}", f"decode:b{B}p{P}n{new}")
        else:
            names = (f"generate:b{B}p{P}n{new}",)
        fn = self._get_generate(P, new, do_sample, temperature, top_k, top_p,
                                with_mask=with_mask, external_prefill=split)
        cache = self._workspace.take(B, required_cache_len(P, new, chunk),
                                     self.compute_dtype)
        if not isinstance(fn, CapturedGenerate) \
                or fn.captured(cache, self._gen):
            return {name: 0.0 for name in names}
        ids = torch.zeros((B, P), dtype=torch.long, device=self.device)
        mask = torch.ones_like(ids) if with_mask else None
        timings = {}
        self._accel.synchronize(self.device)
        t0 = time.perf_counter()
        self._generate_once(ids, new, do_sample, temperature, top_k, top_p,
                            -1, mask, timings)
        self._accel.synchronize(self.device)
        t1 = time.perf_counter()
        if split:
            return {names[0]: timings["prefill"] - t0,
                    names[1]: t1 - timings["prefill"]}
        return {names[0]: t1 - t0}

    def serve(self, monitor=None, draft_module=None, draft_params=None,
              **overrides):
        """A continuous-batching :class:`~deepspeed_tpu_torch.inference.
        serving.ServingEngine` over this engine: ``submit()`` requests,
        ``drain()`` results; requests join freed slots between decode blocks
        instead of waiting for a whole batch.  Knobs come from the config's
        ``serving`` block, overridable per call (``engine.serve(
        num_slots=16)``); ``paged=True`` swaps the per-slot lanes for a
        block-table page pool with prefix sharing (``engine.serve(
        paged=True, page_size=64)``); ``speculative=True, spec_k=k`` decodes
        speculatively (greedy) with the draft ``spec_draft_model`` names
        (``"self"`` or an OPT preset) or the ``draft_module`` /
        ``draft_params`` pair given here (a port ``Transformer`` and its
        float ``state_dict``, e.g. from ``params_from_flax``).  ``monitor``
        (a :class:`~deepspeed_tpu_torch.monitor.monitor.Monitor`) receives
        the ``Serving/*`` events every scheduler iteration and is flushed at
        ``close()`` / ``preempt()``.  Runs on this engine's device; put an
        HTTP front end on it with
        :func:`~deepspeed_tpu_torch.inference.serving.serve_http`.

        At tensor-parallel size > 1 every rank of the group calls
        ``serve()``: tp rank 0 takes the requests and drives the server,
        the other ranks run ``follow()`` (:mod:`~deepspeed_tpu_torch.
        inference.serving.tp_schedule`)."""
        from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
        return ServingEngine(self, monitor=monitor, draft_module=draft_module,
                             draft_params=draft_params, **overrides)


def _flax_flat(flat):
    """``{flax path: tensor}`` of an export → float32 numpy leaves under
    paths relative to the ``params`` collection (``params_from_flax``'s
    input); HF-named keys (dots, no flax path) raise."""
    if any("." in k and "/" not in k for k in flat):
        raise ValueError(
            "this file carries HF-named keys (an hf_policy export); load it "
            "through module_inject.convert_hf_model (an object with the HF "
            "config and this state dict) instead")
    return {(k[len("params/"):] if k.startswith("params/") else k):
            (v.float().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in flat.items()}


def require_right_padded(attention_mask):
    """Validate a generation attention_mask at the API boundary: every row
    must be RIGHT-padded (1s then 0s) and non-empty."""
    m = attention_mask.cpu().numpy() if isinstance(
        attention_mask, torch.Tensor) else np.asarray(attention_mask)
    if not (np.diff(m.astype(np.int8), axis=1) <= 0).all():
        raise ValueError(
            "attention_mask must be RIGHT-padded (1s then 0s per row); "
            "re-tokenize with padding_side='right'")
    if (m.sum(axis=1) == 0).any():
        raise ValueError("attention_mask has an all-padding row (empty "
                         "prompt) — drop it before generate()")


class KVCacheWorkspace:
    """Engine-owned persistent KV-cache buffers: one per cache tensor
    (``"k"``, ``"v"`` and an int8 cache's scales), grown to the largest
    generation served so far; a generation takes a view of each buffer's
    first elements in its own ``(batch, length)`` shape and writes into it
    in place.  Stale contents are harmless: every attention path masks
    positions beyond each row's live length, and a buffer only ever holds
    values of its own dtype.

    Captured decode graphs hold these buffers' addresses, so every shape
    the buffers served keeps its graphs; growing the buffers or
    :meth:`release` calls ``on_drop`` first, which drops the graphs — a
    graph never replays onto freed memory."""

    def __init__(self, module, on_drop=None):
        self._module = module
        # ``on_drop`` is the owning engine's bound method, held weakly: a
        # strong reference back would make a cycle that keeps the engine,
        # its graphs and its buffers alive after the last ``del`` until
        # Python's cycle collector happens to run
        self._on_drop = None if on_drop is None else weakref.WeakMethod(
            on_drop)
        self._bufs = {}
        self._cache = None

    def take(self, batch_size, max_len, dtype):
        spec = self._module.init_cache(int(batch_size), int(max_len),
                                       dtype=dtype, device="meta")
        if set(spec) != set(self._bufs) or any(
                self._bufs[k].dtype != t.dtype
                or self._bufs[k].numel() < t.numel()
                for k, t in spec.items()):
            sizes = {k: max(t.numel(), self._bufs[k].numel()
                            if k in self._bufs
                            and self._bufs[k].dtype == t.dtype else 0)
                     for k, t in spec.items()}
            self.release()                  # drop the old buffers first
            self._bufs = {k: torch.zeros(sizes[k], dtype=t.dtype,
                                         device=self._module.device)
                          for k, t in spec.items()}
        # the cache last handed out (its views)
        self._cache = {k: self._bufs[k][:t.numel()].view(t.shape)
                       for k, t in spec.items()}
        return self._cache

    def release(self):
        drop = None if self._on_drop is None else self._on_drop()
        if self._bufs and drop is not None:
            drop()
        self._bufs = {}
        self._cache = None


def auto_prefill_chunk(batch_size, prompt_len, token_budget=None):
    """The chunked-prefill chunk size, or None for one-pass prefill:
    chunking starts when ``B x P`` exceeds the token budget (env
    ``DSTPU_PREFILL_TOKEN_BUDGET``, default 16384); the chunk targets
    ``B x C <= budget``, floored at 128 and capped at 512."""
    import os
    budget = int(token_budget
                 or os.environ.get("DSTPU_PREFILL_TOKEN_BUDGET", "16384"))
    if batch_size * prompt_len <= budget:
        return None
    c = 512
    while c > 128 and batch_size * c > budget:
        c //= 2
    return c if c < prompt_len else None


def default_prefill_chunk(batch_size, prompt_len):
    """The shared chunk policy.  The JAX package gates it on Pallas
    support; the chunk kernel exists wherever the port runs (CUDA kernel
    or its plain version on the CPU), so there is no gate."""
    return auto_prefill_chunk(batch_size, prompt_len)


def required_cache_len(prompt_len, max_new_tokens, prefill_chunk):
    """KV-workspace length for a generation: chunked prefill right-pads the
    prompt to a chunk multiple and writes those pad positions, so the
    cache covers them.  Rounded up to a multiple of 8 so workspaces have
    the JAX package's shapes (its fused write needs that; K2 does not)."""
    base = prompt_len + max_new_tokens
    if prefill_chunk and prefill_chunk < prompt_len:
        padded = -(-prompt_len // prefill_chunk) * prefill_chunk
        base = max(base, padded)
    return -(-base // 8) * 8


def build_sample_fn(do_sample, temperature, top_k, top_p):
    """The sampling rule: greedy argmax, or temperature / top-k / top-p
    sampling over fp32 logits, drawn with a ``torch.Generator``."""

    def sample_fn(logits, generator):
        logits = logits.float()
        if not do_sample:
            return torch.argmax(logits, dim=-1)
        if temperature != 1.0:
            logits = logits / max(temperature, 1e-6)
        if top_k > 0:
            kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
            logits = torch.where(logits < kth, -1e30, logits)
        if 0.0 < top_p < 1.0:
            sorted_logits = torch.sort(logits, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
            cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
            cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
            logits = torch.where(logits < cutoff, -1e30, logits)
        probs = torch.softmax(logits, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    return sample_fn


def _prefill(module, prompt_len, sample_fn, with_mask, external_prefill,
             cache, input_ids, generator, attention_mask, prefill_logits):
    """The generation prefill: the last real position's logits (one-pass
    prefill through K1 unless ``external_prefill``), the first sampled
    token [B] and the first decode position: ``n`` [B] for padded prompts,
    ``prompt_len`` otherwise."""
    B = input_ids.shape[0]
    if with_mask:
        n = attention_mask.long().sum(1)                        # [B]
        last_pos = n - 1
    else:
        last_pos = torch.full((B,), prompt_len - 1, dtype=torch.long,
                              device=input_ids.device)
    if external_prefill:
        logits = prefill_logits
    else:
        logits, _ = module.decode(input_ids, cache, 0, logits_at=last_pos,
                                  prefill=True)
    return sample_fn(logits[:, 0], generator), n if with_mask else prompt_len


def _check_cache_len(cache, prompt_len, max_new_tokens):
    min_len = prompt_len + max_new_tokens
    if cache["k"].shape[-2] < min_len:
        raise ValueError(
            f"KV cache has {cache['k'].shape[-2]} positions but this "
            f"generation needs >= {min_len} — size it with "
            f"required_cache_len()")


def make_generate_fn(module, prompt_len, max_new_tokens, do_sample,
                     temperature, top_k, top_p, with_mask=False,
                     external_prefill=False, early_exit=True, graphs=False):
    """The generation program: one-pass prefill (flash attention within the
    prompt) unless ``external_prefill``, then the decode loop — with
    ``graphs``, a :class:`CapturedGenerate` (captured decode blocks), else
    a Python loop of single decode steps.

    Returns ``fn(cache, input_ids, generator, eos_id[, attention_mask,
    prefill_logits]) -> ([B, prompt+new], cache)``; the cache is updated in
    place and must hold ``prompt_len + max_new_tokens`` positions.
    ``external_prefill=True`` builds the decode-only program: the caller
    prefilled the cache and passes the last-position logits [B, 1, V].
    ``early_exit`` stops the loop once every row has emitted ``eos_id``;
    tokens are identical either way, since steps after a row's eos emit
    eos."""
    sample_fn = build_sample_fn(do_sample, temperature, top_k, top_p)
    if graphs:
        return CapturedGenerate(module, prompt_len, max_new_tokens,
                                sample_fn, with_mask=with_mask,
                                external_prefill=external_prefill,
                                early_exit=early_exit)

    def generate(cache, input_ids, generator, eos_id, attention_mask=None,
                 prefill_logits=None):
        B = input_ids.shape[0]
        _check_cache_len(cache, prompt_len, max_new_tokens)
        next_tok, pos = _prefill(module, prompt_len, sample_fn, with_mask,
                                 external_prefill, cache, input_ids,
                                 generator, attention_mask, prefill_logits)
        # per-row positions for padded prompts; one shared int otherwise
        done = next_tok == eos_id
        T = max_new_tokens - 1
        toks = torch.full((B, max(T, 0)), eos_id, dtype=torch.long,
                          device=input_ids.device)
        tok = next_tok
        for t in range(T):
            # an eos below 0 can never be sampled, so no row can finish:
            # skip the per-step device-to-host read of `done`
            if early_exit and eos_id >= 0 and bool(done.all()):
                break
            logits, cache = module.decode(tok[:, None], cache, pos)
            nxt = sample_fn(logits[:, -1], generator)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
            toks[:, t] = nxt
            tok = nxt
            pos = pos + 1
        out = torch.cat([input_ids, next_tok[:, None], toks], dim=1)
        return out, cache

    return generate


def make_decode_steps(module, sample_fn, steps):
    """``steps`` decode steps as one capturable program: ``fn(cache,
    state, generator) -> tokens [B, steps]``.  ``state`` holds ``[B]``
    tensors ``token`` (the last token), ``pos`` (its position: every row's
    own, so a replay reads it from the device), ``done`` and ``eos``; each
    step is the eager loop's (sample, eos for rows already done, ``done``
    update), and the new ``token`` / ``pos`` / ``done`` are copied into
    the same tensors, so the next replay continues from them."""

    def decode_steps(cache, state, generator):
        tok, pos, done, eos = (state[k] for k in ("token", "pos", "done",
                                                   "eos"))
        toks = []
        for _ in range(steps):
            logits, _ = module.decode(tok[:, None], cache, pos)
            nxt = sample_fn(logits[:, -1], generator)
            nxt = torch.where(done, eos, nxt)
            done = done | (nxt == eos)
            toks.append(nxt)
            tok = nxt
            pos = pos + 1
        state["token"].copy_(tok)
        state["pos"].copy_(pos)
        state["done"].copy_(done)
        return torch.stack(toks, dim=1)

    return decode_steps


class CapturedGenerate:
    """The captured generation program of one signature (``make_generate_fn
    (..., graphs=True)``), the port's form of the JAX program's prefill
    plus bounded ``while_loop``.

    The prefill stays eager: it runs once per call and is device-bound
    (one pass of K1 and the GEMMs over ``B x P`` tokens, a few hundred
    launches), and a chunked prefill's chunks run eagerly too.  The
    ``T = max_new_tokens - 1`` decode steps run as a graph of
    ``k = DECODE_STEPS_PER_GRAPH`` steps replayed ``T // k`` times and a
    tail graph of ``T % k`` steps (:func:`make_decode_steps`), each a
    :class:`CompiledGraphModule` over the workspace's cache and a
    ``[B]`` state this program owns per batch size.  With ``early_exit``
    and an ``eos_id >= 0``, ``done`` is read once per replay and the
    loop stops once every row is done; tokens equal the eager loop's,
    because steps after a row's eos emit eos and the output starts full
    of eos.  Each replay's tokens are copied out of the graph's output
    before the next replay."""

    def __init__(self, module, prompt_len, max_new_tokens, sample_fn,
                 with_mask=False, external_prefill=False, early_exit=True):
        self.module = module
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.sample_fn = sample_fn
        self.with_mask = with_mask
        self.external_prefill = external_prefill
        self.early_exit = early_exit
        T = max(max_new_tokens - 1, 0)
        k = min(DECODE_STEPS_PER_GRAPH, T) or 1
        self.plan = [k] * (T // k) + ([T % k] if T % k else [])
        self.programs = {n: CompiledGraphModule(
            make_decode_steps(module, sample_fn, n), donate_argnums=(0, 1))
            for n in set(self.plan)}
        self._states = {}

    def _state(self, B, device):
        if B not in self._states:
            kw = dict(dtype=torch.long, device=device)
            self._states[B] = {
                "token": torch.zeros(B, **kw), "pos": torch.zeros(B, **kw),
                "done": torch.zeros(B, dtype=torch.bool, device=device),
                "eos": torch.zeros(B, **kw)}
        return self._states[B]

    def captured(self, cache, generator):
        """True when a call over ``cache`` replays graphs only."""
        state = self._state(cache["k"].shape[1], cache["k"].device)
        return all(p.has_graph(cache, state, generator)
                   for p in self.programs.values())

    def reset(self):
        """Drop the captured graphs (the workspace is being freed)."""
        for p in self.programs.values():
            p.reset()

    def __call__(self, cache, input_ids, generator, eos_id,
                 attention_mask=None, prefill_logits=None):
        B = input_ids.shape[0]
        dev = input_ids.device
        _check_cache_len(cache, self.prompt_len, self.max_new_tokens)
        next_tok, pos = _prefill(self.module, self.prompt_len,
                                 self.sample_fn, self.with_mask,
                                 self.external_prefill, cache, input_ids,
                                 generator, attention_mask, prefill_logits)
        state = self._state(B, dev)
        state["token"].copy_(next_tok)
        if isinstance(pos, torch.Tensor):
            state["pos"].copy_(pos)
        else:
            state["pos"].fill_(pos)
        state["eos"].fill_(eos_id)
        state["done"].copy_(next_tok == eos_id)
        toks = torch.full((B, sum(self.plan)), eos_id, dtype=torch.long,
                          device=dev)
        t = 0
        for n in self.plan:
            if self.early_exit and eos_id >= 0 and bool(state["done"].all()):
                break
            toks[:, t:t + n].copy_(self.programs[n](cache, state, generator))
            t += n
        out = torch.cat([input_ids, next_tok[:, None], toks], dim=1)
        return out, cache
