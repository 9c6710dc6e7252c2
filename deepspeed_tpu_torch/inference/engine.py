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

What has no counterpart here: the JAX engine's AOT compilation, its
persistent executable cache, its compiled-program memory guard and the
``_run_guarded`` retries.  PyTorch runs eagerly, so each call runs the
model directly; cache updates happen in place instead of by donation.
"""

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.accelerator import get_accelerator, resolve_device
from deepspeed_tpu_torch.inference.config import (DeepSpeedInferenceConfig,
                                                  normalize_dtype_str)
from deepspeed_tpu_torch.runtime.weight_quantizer import (WeightQuantization,
                                                          holds_quantized)
from deepspeed_tpu_torch.utils.logging import log_dist, warning_once

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


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
        self._workspace = KVCacheWorkspace(self.module)
        self._gen = self._accel.manual_seed(0, self.device)
        log_dist(f"inference engine on {self._accel.device_name(self.device)}"
                 f", dtype={self.compute_dtype}", ranks=[0])

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
        self._float_layout()
        self.module.load_state_dict(sd, strict=True)
        self._has_params = True
        n = sum(p.numel() for p in self.module.parameters())
        log_dist(f"inference params placed: {n / 1e6:.1f}M, "
                 f"dtype={dtype}", ranks=[0])
        if self._quantizer:
            self._quantize()

    def init_params(self, seed=0):
        """Random init from a ``torch.Generator`` seeded with ``seed``
        (testing / benchmarking without a checkpoint); fp32 and then
        quantized with ``quant.enabled``."""
        gen = self._accel.manual_seed(seed, self.device)
        self._float_layout()
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
        # the JAX engine memoizes a compiled program per signature; an
        # eager loop costs nothing to build
        return make_generate_fn(
            self.module, prompt_len, max_new_tokens, do_sample, temperature,
            top_k, top_p, with_mask=with_mask,
            external_prefill=external_prefill,
            early_exit=self._config.decode_early_exit)

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
            self._gen = self._accel.manual_seed(seed, self.device)
        return self._generate_once(input_ids, int(max_new_tokens),
                                   bool(do_sample), float(temperature),
                                   int(top_k), float(top_p),
                                   int(eos_token_id), attention_mask)

    def _generate_once(self, input_ids, max_new_tokens, do_sample,
                       temperature, top_k, top_p, eos_token_id,
                       attention_mask):
        B, P = input_ids.shape
        chunk = self._prefill_chunk_for(B, P)
        n_chunks = -(-P // chunk) if chunk else 1
        if n_chunks > 1:
            return self._generate_split(input_ids, max_new_tokens, do_sample,
                                        temperature, top_k, top_p,
                                        eos_token_id, attention_mask, chunk)
        fn = self._get_generate(P, max_new_tokens, do_sample, temperature,
                                top_k, top_p,
                                with_mask=attention_mask is not None)
        cache = self._workspace.take(
            B, required_cache_len(P, max_new_tokens, chunk),
            self.compute_dtype)
        try:
            out, cache = fn(cache, input_ids, self._gen, eos_token_id,
                            attention_mask)
        finally:
            self._workspace.give_back(cache)
        return out

    def _generate_split(self, input_ids, max_new_tokens, do_sample,
                        temperature, top_k, top_p, eos_token_id,
                        attention_mask, chunk):
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
        try:
            sel = None
            for ci in range(n):
                local = (last - ci * C).clamp(0, C - 1)
                logits, cache = self.module.decode(
                    ids_pad[:, ci * C:(ci + 1) * C], cache, ci * C,
                    logits_at=local)
                in_chunk = ((last // C) == ci)[:, None, None]
                sel = logits if sel is None \
                    else torch.where(in_chunk, logits, sel)
            fn = self._get_generate(P, max_new_tokens, do_sample, temperature,
                                    top_k, top_p,
                                    with_mask=attention_mask is not None,
                                    external_prefill=True)
            out, cache = fn(cache, input_ids, self._gen, eos_token_id,
                            attention_mask, sel)
        finally:
            self._workspace.give_back(cache)
        return out

    def release_workspace(self):
        """Free the persistent KV-cache workspace buffer."""
        self._workspace.release()

    def serve(self, **overrides):
        """A continuous-batching :class:`~deepspeed_tpu_torch.inference.
        serving.ServingEngine` over this engine: ``submit()`` requests,
        ``drain()`` results; requests join freed slots between decode blocks
        instead of waiting for a whole batch.  Knobs come from the config's
        ``serving`` block, overridable per call (``engine.serve(
        num_slots=16)``); ``paged=True`` swaps the per-slot lanes for a
        block-table page pool with prefix sharing (``engine.serve(
        paged=True, page_size=64)``).  Runs on this engine's device."""
        from deepspeed_tpu_torch.inference.serving.engine import ServingEngine
        return ServingEngine(self, **overrides)


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
    """Engine-owned persistent KV-cache buffer: allocated once per
    ``(batch, length, dtype)`` and reused; generation writes into it in
    place.  Stale contents are harmless: every attention path masks
    positions beyond each row's live length."""

    def __init__(self, module):
        self._module = module
        self._key = None
        self._cache = None

    def take(self, batch_size, max_len, dtype):
        key = (int(batch_size), int(max_len), dtype)
        cache, self._cache = self._cache, None
        if cache is None or self._key != key:
            cache = None                    # drop the old buffer first
            self._key = key
            cache = self._module.init_cache(batch_size, max_len, dtype=dtype)
        return cache

    def give_back(self, cache):
        self._cache = cache

    def release(self):
        self._cache = None
        self._key = None


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


def make_generate_fn(module, prompt_len, max_new_tokens, do_sample,
                     temperature, top_k, top_p, with_mask=False,
                     external_prefill=False, early_exit=True):
    """The generation loop: one-pass prefill (flash attention within the
    prompt) unless ``external_prefill``, then a Python decode loop.

    Returns ``fn(cache, input_ids, generator, eos_id[, attention_mask,
    prefill_logits]) -> ([B, prompt+new], cache)``; the cache is updated in
    place and must hold ``prompt_len + max_new_tokens`` positions.
    ``external_prefill=True`` builds the decode-only loop: the caller
    prefilled the cache and passes the last-position logits [B, 1, V].
    ``early_exit`` stops the loop once every row has emitted ``eos_id``;
    tokens are identical either way, since steps after a row's eos emit
    eos."""
    sample_fn = build_sample_fn(do_sample, temperature, top_k, top_p)

    def generate(cache, input_ids, generator, eos_id, attention_mask=None,
                 prefill_logits=None):
        B = input_ids.shape[0]
        dev = input_ids.device
        min_len = prompt_len + max_new_tokens
        if cache["k"].shape[-2] < min_len:
            raise ValueError(
                f"KV cache has {cache['k'].shape[-2]} positions but this "
                f"generation needs >= {min_len} — size it with "
                f"required_cache_len()")
        if with_mask:
            n = attention_mask.long().sum(1)                    # [B]
            last_pos = n - 1
        else:
            n = None
            last_pos = torch.full((B,), prompt_len - 1, dtype=torch.long,
                                  device=dev)
        if external_prefill:
            logits = prefill_logits
        else:
            logits, cache = module.decode(input_ids, cache, 0,
                                          logits_at=last_pos, prefill=True)
        next_tok = sample_fn(logits[:, 0], generator)
        # per-row positions for padded prompts; one shared int otherwise
        pos = n if with_mask else prompt_len
        done = next_tok == eos_id
        T = max_new_tokens - 1
        toks = torch.full((B, max(T, 0)), eos_id, dtype=torch.long,
                          device=dev)
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
