"""Serving engines: LM decode slots and batched ragged geometry inference.

``ServingEngine`` (counterpart of ``repro/serving/engine.py::ServingEngine``)
serves a causal LM in two modes that share one decode core
(``core.nsa_causal.nsa_causal_decode_paged``):

* lockstep (``generate``): a fixed number of slots decode together at one
  shared cache position.  Prefill is decode replay: prompts stream token by
  token through the decode step, so generation after a prefill equals
  teacher forcing.
* continuous batching (``paged=True``, ``serve``): slots hold independent
  requests at independent positions over paged pools
  (``serving/paged_cache.py``); every step advances every occupied slot by
  one token, finished slots retire and free slots admit queued requests
  mid-flight; hash-chained prefix caching reuses KV blocks across requests
  that share prompt prefixes (copy-on-write on divergence).

The JAX engine jits one step per mode; here the steps run eagerly under
``torch.inference_mode()``, and the greedy, EOS-free paged path runs
windows of W steps whose samples stay on the device
(``launch/steps.py::make_paged_serve_window``).

With ``backend="sharded"`` an engine must be built inside a
``distributed.mesh_context`` (it fails at once otherwise), keeps that mesh
and re-enters it around every call.  The paged engine then holds each
attention pool as this rank's row block (``sharded_backend.shard_pools``;
the block count raised until both pools' rows divide the mesh axis) and
copies blocks on write across the ranks (``RowShards.copy_block``).

``GeometryEngine`` (counterpart of ``repro/serving/engine.py::GeometryEngine``)
serves the point-cloud family: per-cloud
ball-tree permutation on the host → pack → one forward on the model's
device → unpack and inverse-permute.  Two batch layouts:

* ``"packed"`` (the default for BSA, as in the JAX package): the clouds
  concatenated on one axis with a host ``offsets`` array
  (``balltree.pack_varlen``); no dummy slots and no padding to the largest
  cloud, so the forward's work follows Σnᵢ and not B·max nᵢ.
* ``"padded"``: one (B, L, ·) batch with per-sample masks.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.backend import use_backend
from repro_torch.core.balltree import (bucket_length, build_balltree_permutations,
                                       pack_ragged, pack_varlen, unpack_ragged,
                                       unpack_varlen)
from repro_torch.launch.steps import (make_paged_serve_step, make_paged_serve_window,
                                      make_serve_step)
from repro_torch.serving.paged_cache import PagedKVCache

__all__ = ["ServingEngine", "GeometryEngine"]


def _backend_scope(name: str | None, mesh_info=None):
    """Force attention backend ``name`` (None: the config's) and, with
    ``mesh_info`` (the (mesh, axis) an engine captured at construction),
    re-enter its ``mesh_context``, so a mesh-requiring backend finds its
    mesh also when the engine is used outside the caller's block."""
    stack = contextlib.ExitStack()
    if name:
        stack.enter_context(use_backend(name))
    if mesh_info is not None:
        from repro_torch.distributed.sharded_backend import mesh_context
        stack.enter_context(mesh_context(mesh_info[0], axis=mesh_info[1]))
    return stack


def _require_mesh_if_needed(backend_name: str | None, api, engine: str):
    """(mesh, axis) when the engine's effective backend needs a mesh, else
    None.  Fails at construction, with the recipe, where a mesh-requiring
    backend has none.  Resolution follows the backend precedence (config <
    engine override < environment)."""
    from repro_torch.core.backend import ENV_VAR, get_backend
    eff = (os.environ.get(ENV_VAR) or backend_name
           or getattr(api.mcfg.bsa, "backend", None) or "auto")
    try:
        bk = get_backend(eff)
    except KeyError:
        return None                      # unknown names fail later, in use_backend
    if getattr(bk, "requires_mesh", False) is not True:   # "auto" answers any attribute
        return None
    from repro_torch.distributed.sharded_backend import current_mesh_axis
    ctx = current_mesh_axis()
    if ctx is None:
        raise ValueError(
            f"{engine}(backend={eff!r}) needs an active mesh: construct the engine "
            "inside a mesh context, e.g.\n"
            "    from repro_torch.distributed import mesh_context\n"
            "    from repro_torch.launch.mesh import make_local_mesh\n"
            "    with mesh_context(make_local_mesh()):\n"
            f"        engine = {engine}(...)\n"
            "(the engine keeps the mesh, so later calls may run outside the block)")
    return ctx


class ServingEngine:
    def __init__(self, api, model, *, batch_slots: int, max_len: int,
                 cache_dtype=torch.float32, temperature: float = 0.0, seed: int = 0,
                 backend: str | None = None, paged: bool = False,
                 page: int | None = None, num_blocks: int | None = None,
                 prefix_cache: bool = True):
        """``paged=True`` enables continuous batching (``serve``): ``page``
        tokens per pool block (default: the least common multiple of the
        local window and the compression block), ``num_blocks`` pool blocks
        shared by all slots (default: every slot's full capacity,
        ``batch_slots · max_len / page``), ``prefix_cache`` toggles
        cross-request prefix block reuse.  The caches live on the device of
        ``model``'s parameters; ``backend`` forces an attention backend by
        name (None = the model config's)."""
        self.api = api
        self.model = model
        self.B = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.backend = backend
        self._mesh = _require_mesh_if_needed(backend, api, "ServingEngine")
        self.cache_dtype = cache_dtype
        self.device = next(model.parameters()).device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.paged = paged
        if paged:
            if not api.has_paged_decoder:
                raise ValueError(f"family {api.mcfg.family!r} has no paged decode path")
            if page is None:
                bsa = api.mcfg.bsa
                page = math.lcm(bsa.effective_local_window, bsa.cmp_block)
            if max_len % page:
                raise ValueError(f"max_len={max_len} not a multiple of page={page}")
            self.page = page
            self.n_pages = max_len // page
            self.num_blocks = num_blocks or batch_slots * self.n_pages
            if self._mesh is not None:
                # the sharded decode partitions the pools by row: raise the
                # block count until both row counts divide the mesh axis
                p = self._mesh[0].shape[self._mesh[1]]
                cpp = page // api.mcfg.bsa.cmp_block
                while ((self.num_blocks + 1) * page) % p or ((self.num_blocks + 1) * cpp) % p:
                    self.num_blocks += 1
            self._prefix_enabled = prefix_cache and not api.has_recurrent_state
            self._pstep = make_paged_serve_step(api, page=page)
            self._wstep = make_paged_serve_window(api, page=page)
            self._alloc_state()
        else:
            self.caches = api.cache_init(batch_slots, max_len, cache_dtype,
                                         device=self.device)
        self._step = make_serve_step(api)
        self.tokens_generated = 0
        self.decode_time = 0.0
        self.serve_steps = 0

    def _alloc_state(self):
        self.kv = PagedKVCache(n_slots=self.B, num_blocks=self.num_blocks,
                               page=self.page, n_pages=self.n_pages,
                               prefix_cache=self._prefix_enabled)
        self.caches = self.api.paged_cache_init(self.B, self.num_blocks, self.page,
                                                self.cache_dtype, device=self.device)
        if self._mesh is not None:           # this rank's row block of each pool
            from repro_torch.distributed.sharded_backend import shard_paged_caches
            self.caches = shard_paged_caches(self.caches, *self._mesh)

    def reset(self, cache_dtype=None):
        """Drop all cached state.  ``cache_dtype=None`` keeps the engine's
        dtype; passing one switches it from here on."""
        if cache_dtype is not None:
            self.cache_dtype = cache_dtype
        if self.paged:
            self._alloc_state()
        else:
            self.caches = self.api.cache_init(self.B, self.max_len, self.cache_dtype,
                                              device=self.device)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a)).to(self.device)

    @torch.inference_mode()
    def prefill(self, prompts: np.ndarray) -> torch.Tensor:
        """prompts: (B, P) int — replayed through the decode step.  Returns
        the argmax of the last logits (the first generated token), on the
        device."""
        if prompts.shape[0] != self.B:
            raise ValueError(f"prompts must have {self.B} rows, got {prompts.shape[0]}")
        toks = self._dev(prompts.astype(np.int64))
        nxt = None
        with _backend_scope(self.backend, self._mesh):
            for t in range(toks.shape[1]):
                nxt, _, self.caches = self._step(self.model, self.caches, toks[:, t])
        return nxt

    def _sample(self, logits):
        if self.temperature <= 0.0:
            return logits.argmax(-1).to(torch.int32)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(torch.int32)

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, n_tokens: int, eos_id: int | None = None,
                 pad_id: int = 0) -> np.ndarray:
        """Greedy or temperature generation.  Returns (B, n_tokens).

        With ``eos_id`` set, a slot that samples it retires: its remaining
        columns are ``pad_id``, it is no longer counted, and the loop stops
        once every slot is done; each step's samples then come back to the
        host.  Without it the samples stay on the device until the end."""
        tok = self.prefill(prompts)
        first = tok.cpu().numpy()                # waits for the prefill, as JAX does
        done = np.zeros(self.B, bool)
        t0 = time.perf_counter()
        if eos_id is None:
            out = [tok]
            with _backend_scope(self.backend, self._mesh):
                for _ in range(n_tokens - 1):
                    _, logits, self.caches = self._step(self.model, self.caches, tok)
                    tok = self._sample(logits)
                    out.append(tok)
            result = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
            self.tokens_generated += self.B * n_tokens
        else:
            done |= first == eos_id
            emit = np.where(done, pad_id, first).astype(np.int32)
            out = [emit]
            self.tokens_generated += int((~done).sum())
            with _backend_scope(self.backend, self._mesh):
                for _ in range(n_tokens - 1):
                    if done.all():
                        break
                    _, logits, self.caches = self._step(
                        self.model, self.caches, self._dev(emit.astype(np.int64)))
                    s = self._sample(logits).cpu().numpy()
                    done |= s == eos_id
                    emit = np.where(done, pad_id, s).astype(np.int32)
                    out.append(emit)
                    self.tokens_generated += int((~done).sum())
            while len(out) < n_tokens:                       # early-exit padding
                out.append(np.full(self.B, pad_id, np.int32))
            result = np.stack(out, axis=1)
        self.decode_time += time.perf_counter() - t0
        return result

    # -- continuous batching over the paged cache ---------------------------

    @torch.inference_mode()
    def serve(self, prompts, max_new_tokens: int,
              eos_id: int | None = None) -> list[np.ndarray]:
        """Continuous-batching generation over a list of requests.

        ``prompts``: 1-D int token arrays of any lengths up to ``max_len``.
        Returns one generated-token array per prompt (EOS excluded, at most
        ``max_new_tokens``; a slot also stops at its capacity).  Every step
        advances every occupied slot by one token — replaying its prompt
        (prefill) or feeding its last sample (decode).  Greedy without EOS
        takes the windowed path; otherwise one step at a time, with each
        step's samples back on the host when EOS decides retirement."""
        if not self.paged:
            raise RuntimeError("serve() requires ServingEngine(paged=True)")
        prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
        if eos_id is None and self.temperature <= 0.0:
            return self._serve_windowed(prompts, max_new_tokens)
        results: list = [None] * len(prompts)
        queue = deque(range(len(prompts)))
        kv = self.kv
        slot_req = np.full(self.B, -1, np.int64)
        slot_feed = np.zeros(self.B, np.int64)
        slot_decode = np.zeros(self.B, bool)    # feed = last sample, not prompt
        slot_gen: list[list] = [[] for _ in range(self.B)]
        # EOS makes the schedule depend on the samples: they come back every
        # step.  Without it (temperature sampling) they stay on the device
        # and feed back there; the history is pulled once at the end.
        sync = eos_id is not None
        hist: list = []                          # (B,) device samples per step
        dev_table, tver = None, -1
        prev = None
        t0 = time.perf_counter()
        with _backend_scope(self.backend, self._mesh):
            while queue or (slot_req >= 0).any():
                # 1) admission into free slots (prefix-reuse aware)
                for s in range(self.B):
                    if slot_req[s] < 0 and queue:
                        rid = queue.popleft()
                        reused = kv.admit(s, prompts[rid])
                        self.caches = self.api.cache_reset_slot(self.caches, s)
                        slot_req[s] = rid
                        slot_gen[s] = []
                        slot_feed[s] = prompts[rid][reused]
                        slot_decode[s] = False
                # 2) make every occupied slot's next position writable
                for s in np.nonzero(slot_req >= 0)[0]:
                    for op in kv.prepare_append(int(s)):
                        self.caches = self.api.cache_copy_block(self.caches, op.src,
                                                                op.dst, self.page)
                if kv.version != tver:           # table changed since the last push
                    dev_table = self._dev(kv.table)
                    tver = kv.version
                # 3) one decode step for the whole batch
                tok = self._dev(slot_feed)
                if not sync and prev is not None and slot_decode.any():
                    tok = torch.where(self._dev(slot_decode), prev.long(), tok)
                _, logits, self.caches = self._pstep(self.model, self.caches, tok,
                                                     dev_table, self._dev(kv.lengths))
                prev = self._sample(logits)
                if sync:
                    sampled = prev.cpu().numpy()
                else:
                    hist.append(prev)
                self.serve_steps += 1
                # 4) commit, transition, retire, publish prefix pages
                step_idx = len(hist) - 1
                for s in range(self.B):
                    rid = int(slot_req[s])
                    if rid < 0:
                        continue
                    prompt = prompts[rid]
                    fed_pos = int(kv.lengths[s])
                    kv.committed(s)
                    kv.seal_prompt_page(s, prompt)
                    if fed_pos < len(prompt) - 1:
                        slot_feed[s] = prompt[fed_pos + 1]   # prefill replay
                        slot_decode[s] = False
                        continue
                    done = False                             # decode sample
                    if sync:
                        t_s = int(sampled[s])
                        done = t_s == eos_id
                        if not done:
                            slot_gen[s].append(t_s)
                            slot_feed[s] = t_s
                    else:
                        slot_gen[s].append((step_idx, s))    # resolved at the end
                    if not done:
                        self.tokens_generated += 1
                        slot_decode[s] = True
                        done = (len(slot_gen[s]) >= max_new_tokens
                                or int(kv.lengths[s]) >= kv.capacity)
                    if done:
                        results[rid] = slot_gen[s]
                        kv.retire(s)
                        slot_req[s] = -1
                        slot_feed[s] = 0
                        slot_decode[s] = False
        if hist:
            all_samples = torch.stack(hist).cpu().numpy()    # the one pull
            results = [np.asarray([all_samples[i, s] for i, s in r], np.int32)
                       for r in results]
        else:
            results = [np.asarray(r, np.int32) for r in results]
        self.decode_time += time.perf_counter() - t0
        return results

    MAX_WINDOW = 32

    @torch.inference_mode()
    def _serve_windowed(self, prompts, max_new_tokens: int) -> list[np.ndarray]:
        """The greedy, EOS-free path of :meth:`serve`: windows of W steps.

        Without EOS the schedule depends only on lengths, which the host
        knows ahead, so between scheduling events (a slot retiring, a
        request admitted) there is nothing to decide per step.  W = steps
        until the next retirement, rounded down to a power of two and capped
        at ``MAX_WINDOW`` (the JAX engine's schedule, there to bound its
        compiled variants; kept so both engines step alike).  Every page the
        window touches is prepared first, and the samples come back once, at
        the end."""
        results: list = [None] * len(prompts)
        queue = deque(range(len(prompts)))
        kv = self.kv
        slot_req = np.full(self.B, -1, np.int64)
        slot_gen: list[list] = [[] for _ in range(self.B)]
        hist: list = []                          # (W, B) device samples
        base = 0                                 # global step index of the window
        dev_table, tver = None, -1
        prev = torch.zeros(self.B, dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        with _backend_scope(self.backend, self._mesh):
            while queue or (slot_req >= 0).any():
                for s in range(self.B):          # admission into free slots
                    if slot_req[s] < 0 and queue:
                        rid = queue.popleft()
                        kv.admit(s, prompts[rid])
                        self.caches = self.api.cache_reset_slot(self.caches, s)
                        slot_req[s] = rid
                        slot_gen[s] = []
                occ = np.nonzero(slot_req >= 0)[0]
                horizon = self.MAX_WINDOW        # steps until the first retirement
                for s in occ:
                    pr = prompts[slot_req[s]]
                    stop = min(len(pr) - 1 + max_new_tokens, kv.capacity)
                    horizon = min(horizon, stop - int(kv.lengths[s]))
                W = 1 << (int(horizon).bit_length() - 1)
                feed = np.zeros((W, self.B), np.int32)
                use_prev = np.zeros((W, self.B), bool)
                for s in occ:
                    pr = prompts[slot_req[s]]
                    t = int(kv.lengths[s])
                    for op in kv.prepare_window(int(s), W):
                        self.caches = self.api.cache_copy_block(self.caches, op.src,
                                                                op.dst, self.page)
                    n_pref = max(0, min(W, len(pr) - t))     # prompt feeds
                    feed[:n_pref, s] = pr[t:t + n_pref]
                    use_prev[n_pref:, s] = True              # then self-feed
                if kv.version != tver:
                    dev_table = self._dev(kv.table)
                    tver = kv.version
                samples, self.caches = self._wstep(
                    self.model, self.caches, self._dev(feed), self._dev(use_prev), prev,
                    dev_table, self._dev(kv.lengths.astype(np.int64)),
                    self._dev((slot_req >= 0).astype(np.int64)))
                prev = samples[-1]
                hist.append(samples)
                self.serve_steps += W
                for s in occ:
                    rid = int(slot_req[s])
                    pr = prompts[rid]
                    old = int(kv.lengths[s])
                    kv.committed(int(s), W)
                    kv.seal_prompt_pages(int(s), pr, old)
                    gen0 = min(W, max(0, len(pr) - 1 - old))  # first decode step
                    for i in range(gen0, W):
                        slot_gen[s].append((base + i, s))
                    self.tokens_generated += W - gen0
                    if len(slot_gen[s]) >= max_new_tokens or old + W >= kv.capacity:
                        results[rid] = slot_gen[s]
                        kv.retire(int(s))
                        slot_req[s] = -1
                base += W
        if hist:                                 # the one device → host pull
            allv = torch.cat(hist).cpu().numpy()
            results = [np.asarray([allv[i, s] for i, s in r], np.int32) for r in results]
        self.decode_time += time.perf_counter() - t0
        return results

    @property
    def tokens_per_second(self) -> float:
        return self.tokens_generated / max(self.decode_time, 1e-9)


class GeometryEngine:
    """Serve (points, feats) clouds of any sizes, in request order, grouped
    into batches of ``batch_slots``.

    ``layout`` is ``"packed"`` or ``"padded"``; None picks ``"packed"`` for
    BSA models.  ``pad_to`` freezes the batch shape: the total packed
    capacity in the packed layout, the per-slot padded length in the padded
    one; otherwise each batch pads to a geometric bucket (of the packed
    total, resp. of its largest cloud).  A short final batch repeats the last
    offset (packed) or is filled with fully-masked dummy slots (padded), for
    which every branch returns exact zeros.  ``backend`` forces an attention
    backend by name for the engine's forwards (None = the model config's).
    The forward runs on the device of ``model``'s parameters; packed
    ``offsets`` stay on the host.
    """

    def __init__(self, api, model, *, batch_slots: int = 8,
                 pad_to: int | None = None, backend: str | None = None,
                 layout: str | None = None):
        self._mesh = _require_mesh_if_needed(backend, api, "GeometryEngine")
        if layout is None:
            layout = "packed" if api.mcfg.attention == "bsa" else "padded"
        if layout not in ("packed", "padded"):
            raise ValueError(f"layout must be 'packed' or 'padded', got {layout!r}")
        self.api = api
        self.model = model
        self.batch_slots = batch_slots
        self.pad_to = pad_to
        self.backend = backend
        self.layout = layout
        self.ball_size = api.mcfg.bsa.ball_size
        self.device = next(model.parameters()).device
        self.clouds_served = 0
        self.points_served = 0
        self.predict_time = 0.0

    @torch.no_grad()
    def predict(self, clouds) -> list[np.ndarray]:
        """clouds: ``(points (n_i, d), feats (n_i, in_dim))`` pairs or dicts
        with those keys.  Returns one (n_i, out_dim) array per cloud, rows
        in the caller's original point order.  Runs under no-grad."""
        clouds = [(c["points"], c["feats"]) if isinstance(c, dict) else c
                  for c in clouds]
        results: list[np.ndarray] = []
        t0 = time.perf_counter()
        for s in range(0, len(clouds), self.batch_slots):
            results.extend(self._predict_batch(clouds[s:s + self.batch_slots]))
        self.predict_time += time.perf_counter() - t0
        self.clouds_served += len(clouds)
        self.points_served += sum(int(np.asarray(p).shape[0]) for p, _ in clouds)
        return results

    def pack_batch(self, chunk):
        """Ball-order and pack up to ``batch_slots`` (points, feats) clouds:
        returns (batch, mask as numpy, per-cloud permutations).  The batch
        holds "feats" (B, L, in_dim) and "mask" (B, L) on the model's device
        (B = 1 in the packed layout) and, packed, "offsets" (batch_slots + 1,)
        int32 on the host."""
        pts_list = [np.asarray(p) for p, _ in chunk]
        fts_list = [np.asarray(f, np.float32) for _, f in chunk]
        perms = build_balltree_permutations(pts_list, self.ball_size)
        ordered = [f[perm] for f, perm in zip(fts_list, perms)]
        if self.layout == "packed":
            feats, offsets, mask = pack_varlen(ordered, self.ball_size, pad_to=self.pad_to,
                                               max_samples=self.batch_slots)
            batch = {"feats": torch.from_numpy(feats[None]).to(self.device),
                     "mask": torch.from_numpy(mask[None]).to(self.device),
                     "offsets": torch.from_numpy(offsets)}
            return batch, mask[None], perms
        target = self.pad_to or bucket_length(
            max(f.shape[0] for f in ordered), self.ball_size)
        pad_slots = self.batch_slots - len(chunk)
        if pad_slots > 0:
            ordered += [np.zeros((1, ordered[0].shape[1]), np.float32)] * pad_slots
        feats, mask = pack_ragged(ordered, self.ball_size, pad_to=target)
        if pad_slots > 0:
            mask[len(chunk):] = False
        batch = {"feats": torch.from_numpy(feats).to(self.device),
                 "mask": torch.from_numpy(mask).to(self.device)}
        return batch, mask, perms

    def _predict_batch(self, chunk) -> list[np.ndarray]:
        batch, mask, perms = self.pack_batch(chunk)
        with _backend_scope(self.backend, self._mesh):
            pred = self.api.forward(self.model, batch)
        if self.layout == "packed":
            per_cloud = unpack_varlen(pred[0].cpu().numpy(),
                                      batch["offsets"].numpy()[:len(chunk) + 1], mask[0])
        else:
            per_cloud = unpack_ragged(pred.cpu().numpy(), mask)[:len(chunk)]
        out = []
        for rows, perm in zip(per_cloud, perms):
            unperm = np.empty_like(rows)
            unperm[perm] = rows                    # ball order → original order
            out.append(unperm)
        return out

    @property
    def points_per_second(self) -> float:
        return self.points_served / max(self.predict_time, 1e-9)
