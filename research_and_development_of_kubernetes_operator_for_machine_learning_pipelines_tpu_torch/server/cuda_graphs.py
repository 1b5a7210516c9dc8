"""Programs replayed from captured CUDA graphs: the fused K-step decode
(``llama.decode_multistep``, :class:`MultistepProgram`) and the unified
super-step (``llama.super_step_ragged`` plus the packed finalize,
:class:`SuperstepProgram`), each on static buffers, one captured graph per
variant on the card.

The reference jits one XLA program per ``(K, window)`` pair and token
rule and chains its dispatches on device arrays ("chained dispatches pass
NO host arrays").  Here the counterpart of one jitted program is one
``torch.cuda.CUDAGraph``: a replay issues the K forwards' launches (some
thousand at Llama-2-7B's 32 layers) from one host call.

- **Static buffers.**  The program owns every input of the call (tokens,
  lengths, active, remaining, EOS ids, keys, temperatures, top-k, top-p)
  and its two outputs (the token block and ``valid``); the cache tensors
  are used in place.  Their addresses never change, so every graph reads
  and writes the same memory.
- **Chaining.**  The captured region ends by copying the chained outputs
  (tokens, lengths, active, remaining, keys) back into the inputs, so the
  next replay needs no host work.
- **The lag-1 readback.**  Right after a replay the token block and
  ``valid`` are copied (non-blocking) into one of two pinned host buffers
  and an event is recorded; the harvest of that tick waits on the event.
  The next replay overwrites the graph's outputs, never the buffer a
  pending harvest reads.
- **One pool.**  Every graph allocates from one shared memory pool: they
  never run at once, and each one's outputs are copied out before the
  next one runs.
- **Launch counts.**  A kernel wrapper counts a launch when Python calls
  it, which a capture does once and a replay never.  The program records
  each graph's launches per counter at capture, takes them back off the
  counters (a capture launches nothing), and adds them on every replay.
- **Kept graphs.**  With :data:`KEEP_GRAPHS` set before a capture, each
  graph keeps its node list after instantiation, so a check can read the
  kernels a replay launches (:meth:`_GraphProgram.kernel_nodes`) without a
  profiler.  Off by default: the node lists cost host memory.
- **Captured or not, decided at construction.**  A program on the card
  with no mesh (one rank) is captured.  A program with a mesh (a world
  above one rank) runs uncaptured, on gloo and NCCL alike: each tick calls
  the same ``_run`` eagerly on the same static buffers, with the chaining,
  the pinned readbacks and their events unchanged, and the launch counters
  count its launches as the single-step path counts them.  The leader's
  dispatch and every follower's replay take that path.  The capture of
  collectives into the graphs is not ported (gloo's are host calls, which
  no graph captures).  On the CPU (the tests, ``device='cpu'``) the program
  runs uncaptured too, which exercises everything but the graph.
- **No fallback.**  A capture or a replay that fails on the card raises,
  and so does a variant that was never captured; nothing chooses the
  uncaptured path after an error.

The super-step takes a host array for every input of a tick (the engine
rebuilds the rows' roles each tick, as the reference does): they go
through one pinned int32 staging buffer, one copy to the card, and are
unpacked inside the graph.  Its outputs are packed into one int32 buffer
and read back synchronously after the replay.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..models import llama
from ..models.sampling import sample_chain_step
from ..ops import decode_attention, flash_attention, rmsnorm, sample_step

# The launch counters a replay advances: name -> (module, attribute).
_COUNTERS = {"decode_attention": (decode_attention, "launches"),
             "verify_attention": (decode_attention, "verify_launches"),
             "rmsnorm": (rmsnorm, "launches"),
             "flash_attention": (flash_attention, "launches"),
             "sample_step": (sample_step, "launches")}


# Keep every graph captured from now on (``keep_graph=True``), for
# :meth:`_GraphProgram.kernel_nodes`.
KEEP_GRAPHS = False


def program_mode(device, mesh=None) -> tuple[bool, str]:
    """Whether a program on ``device`` over ``mesh`` (a
    ``parallel.ServingMesh``, None for one rank) is captured into CUDA
    graphs, and why: on the card with no mesh only.  The one place the
    choice is made; a program makes it once, at construction."""
    if torch.device(device).type != "cuda":
        return False, "uncaptured (cpu)"
    if mesh is not None and mesh.world > 1:
        return False, f"uncaptured (world {mesh.world})"
    return True, "captured"


class _GraphProgram:
    """What the two programs share: the engine's device state as static
    buffers (tokens, lengths, keys, temperatures, top-k, top-p; the cache in
    place), one private graph pool, the capture of one graph a (window,
    token rule) on a side stream after one eager warm-up run a token rule,
    and the launch counts each graph records at capture and adds at every
    replay; or, uncaptured (:func:`program_mode`), the same call eagerly on
    the same buffers each tick.  A subclass defines :meth:`_run`, the call
    on its buffers."""

    kind = ""  # the tick kind it dispatches

    def __init__(self, params, cfg, cache, dtype, device, mesh=None):
        self._params = params
        self._cfg = cfg
        self._mesh = mesh  # parallel.ServingMesh: this rank's block (uncaptured)
        self._dtype = dtype
        self.device = torch.device(device)
        self.captured, self.why = program_mode(self.device, mesh)
        b = int(cache.lengths.shape[0])
        self.batch = b
        dev = self.device
        self.tokens = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.keys = torch.zeros((b, 2), dtype=torch.int64, device=dev)
        self.temps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.topk = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.topp = torch.ones((b,), dtype=torch.float32, device=dev)
        self.cache = cache._replace(lengths=self.lengths)
        self.cuda = dev.type == "cuda"
        # (window, sampling) -> (graph, {counter name: launches a replay})
        self.graphs: dict[tuple[int, bool], tuple] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.captured else None
        self.capture_s = 0.0
        self.replays = 0

    @property
    def mode(self) -> str:
        """What runs a tick, as ``/debug/device`` reports it, e.g.
        ``"multistep, uncaptured (world 4)"``."""
        return f"{self.kind}, {self.why}"

    def _run(self, window: int, sampling: bool) -> None:
        raise NotImplementedError

    def _check_parked(self) -> None:
        """Raise unless the staged inputs advance nothing (a capture's
        warm-up and capture runs must not move the engine's state)."""
        raise NotImplementedError

    def _sampler(self, sampling: bool):
        """The per-step token rule over the static buffers, and its carry."""
        if sampling:
            def sample(logits, carry):
                return sample_chain_step(logits, carry, self.temps, self.topk, self.topp)
            return sample, self.keys

        def greedy(logits, carry):
            return carry, torch.argmax(logits, dim=-1)
        return greedy, None

    def load_state(self, tokens, lengths, keys, temps, topk, topp) -> None:
        """The engine's device state into the static buffers (a tensor that
        already is the buffer is left alone)."""
        for buf, t in ((self.tokens, tokens), (self.lengths, lengths), (self.keys, keys),
                       (self.temps, temps), (self.topk, topk), (self.topp, topp)):
            if t is not buf:
                buf.copy_(t)

    # -- capture -------------------------------------------------------------

    def capture(self, windows, on_graph=None) -> None:
        """Capture one graph per (window, sampling mode) on the staged,
        parked inputs; the keys and tokens are restored after the warm-up
        runs, which may split or rewrite them.  ``on_graph(seconds)`` is
        called after each graph with the wall of its capture.  An
        uncaptured program records nothing."""
        if not self.captured:
            return
        self._check_parked()
        saved = (self.keys.clone(), self.tokens.clone())
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        for sampling in (False, True):
            # One eager run a token rule on a side stream first: cuBLAS
            # and the kernels' libraries set up outside the capture.
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._run(min(windows), sampling)
            torch.cuda.current_stream(self.device).wait_stream(side)
            for window in windows:
                t_graph = time.perf_counter()
                before = {name: getattr(m, a) for name, (m, a) in _COUNTERS.items()}
                graph = (torch.cuda.CUDAGraph(keep_graph=True) if KEEP_GRAPHS
                         else torch.cuda.CUDAGraph())
                # thread_local: another engine's scheduler thread in this
                # process may use the card while this one captures.
                with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                    self._run(int(window), sampling)
                if KEEP_GRAPHS:
                    graph.instantiate()  # now, not at the first replay
                deltas = {}
                for name, (m, a) in _COUNTERS.items():
                    deltas[name] = getattr(m, a) - before[name]
                    setattr(m, a, before[name])  # a capture launches nothing
                self.graphs[(int(window), bool(sampling))] = (graph, deltas)
                if on_graph is not None:
                    on_graph(time.perf_counter() - t_graph)
        self.keys.copy_(saved[0])
        self.tokens.copy_(saved[1])
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0

    def _replay(self, window: int, sampling: bool) -> None:
        """One tick: the graph's replay (its recorded launches added to the
        counters), or, uncaptured, the eager call (its wrappers count their
        own launches)."""
        key = (int(window), bool(sampling))
        if self.captured:
            graph, deltas = self.graphs[key]  # a missing variant raises: no eager fallback
            graph.replay()
            for name, n in deltas.items():
                m, a = _COUNTERS[name]
                setattr(m, a, getattr(m, a) + n)
        else:
            self._run(*key)
        self.replays += 1

    def kernel_nodes(self, window: int, sampling: bool, path) -> str:
        """The ``(window, sampling)`` graph's nodes as Graphviz text (written
        to ``path``): a kernel node's label holds its kernel's mangled name,
        once.  Only for a graph captured with :data:`KEEP_GRAPHS` set."""
        graph, _ = self.graphs[(int(window), bool(sampling))]
        graph.enable_debug_mode()
        graph.debug_dump(str(path))
        with open(path) as f:
            return f.read()

    def drop(self) -> None:
        """Forget every graph (the cache they point at is being freed)."""
        self.graphs.clear()

    def pool_bytes(self, key: str = "total_size") -> int:
        """Bytes the graphs' private pool holds on the card (``key``
        ``allocated_size``: those of live blocks, which the allocator counts
        as allocated)."""
        if self.pool is None:
            return 0
        stats = torch.cuda.memory.memory_snapshot()
        return sum(seg[key] for seg in stats
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))


class MultistepProgram(_GraphProgram):
    """``steps`` decode iterations on static buffers over ``cache``, chained
    from one dispatch to the next, harvested one tick late."""

    kind = "multistep"

    def __init__(self, params, cfg, cache, steps: int, dtype, device, mesh=None):
        super().__init__(params, cfg, cache, dtype, device, mesh)
        self.steps = int(steps)
        b, dev = self.batch, self.device
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.eos_ids = torch.full((b,), -1, dtype=torch.int32, device=dev)
        self.tok_block = torch.zeros((b, self.steps), dtype=torch.int64, device=dev)
        self.valid = torch.zeros((b,), dtype=torch.int32, device=dev)
        # Two host buffers for the lag-1 readback, each with its event.
        self._host = [
            (torch.zeros((b, self.steps), dtype=torch.int64, pin_memory=self.cuda),
             torch.zeros((b,), dtype=torch.int32, pin_memory=self.cuda),
             torch.cuda.Event() if self.cuda else None)
            for _ in range(2)
        ]
        self._flip = 0

    def _run(self, window: int, sampling: bool) -> None:
        """One ``decode_multistep`` on the static buffers, its outputs into
        the output buffers and its chained state back into the inputs."""
        sample, carry0 = self._sampler(sampling)
        tok_block, valid, toks, cache, act, rem, carry = llama.decode_multistep(
            self._params, self.tokens, self.cache, self._cfg, self.active, self.remaining,
            self.eos_ids, self.steps, sample, sample_carry=carry0, dtype=self._dtype,
            window=window, mesh=self._mesh,
        )
        self.tok_block.copy_(tok_block)
        self.valid.copy_(valid)
        self.tokens.copy_(toks)
        self.lengths.copy_(cache.lengths)
        self.active.copy_(act)
        self.remaining.copy_(rem)
        if sampling:
            self.keys.copy_(carry)

    def _check_parked(self) -> None:
        if bool(self.active.any()):
            raise RuntimeError("capture needs all-inactive rows")

    # -- burst ---------------------------------------------------------------

    def load(self, tokens, lengths, keys, temps, topk, topp, active_np, remaining_np,
             eos_np) -> None:
        """Burst entry: the engine's state into the static buffers."""
        self.load_state(tokens, lengths, keys, temps, topk, topp)
        self.active.copy_(torch.from_numpy(np.asarray(active_np, bool)))
        self.remaining.copy_(torch.from_numpy(np.asarray(remaining_np, np.int32)))
        self.eos_ids.copy_(torch.from_numpy(np.asarray(eos_np, np.int32)))

    def dispatch(self, window: int, sampling: bool) -> int:
        """One fused tick (:meth:`_replay`), then the outputs' copy into a
        host buffer.  Returns the buffer's index for :meth:`harvest`."""
        self._replay(window, sampling)
        i = self._flip
        self._flip ^= 1
        host_tok, host_valid, event = self._host[i]
        host_tok.copy_(self.tok_block, non_blocking=True)
        host_valid.copy_(self.valid, non_blocking=True)
        if event is not None:
            event.record()
        return i

    def harvest(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Tick ``i``'s token block and ``valid`` on the host, once its
        copies have landed."""
        host_tok, host_valid, event = self._host[i]
        if event is not None:
            event.synchronize()
        return host_tok.numpy().copy(), host_valid.numpy().copy()


class SuperstepOut(NamedTuple):
    """One super-step tick's readback (host arrays)."""

    tok_block: np.ndarray  # [B, K] decode rows' tokens (real for j < valid)
    valid: np.ndarray      # [B]
    greedy: np.ndarray     # [B, S] the wide forward's argmax
    accepted: np.ndarray   # [B] verify rows' accepted drafts
    firsts: np.ndarray     # [B] final prefill rows' first tokens


# The super-step's host inputs, in staging order: int32 [B] fields after the
# token block; the slot keys (two words a row) and the three row parameters
# of final prefill rows (floats staged as their bits) at the end.
_ROW_FIELDS = ("roles", "offsets", "counts", "draft_len", "active", "remaining", "eos_ids",
               "last_pos", "final_lens")


class SuperstepProgram(_GraphProgram):
    """The unified engine's tick on static buffers: ``llama.super_step_ragged``
    (decode, verify and packed-prefill rows of width ``width``, ``steps``
    decode iterations), then the packed finalize: every row's slot key is
    split and the first token drawn from its ``last_pos`` logits
    (``sample_chain_step``, the prep and draw kernels on the card), and the
    keys, temperatures, top-k, top-p, lengths and pending tokens of rows
    whose chunk completes their prompt (``last_pos >= 0``) take the new
    values.  Every input of a tick is a host array (:meth:`stage`); the
    state it chains is the engine's device state, which lives in the
    program's buffers."""

    kind = "superstep"

    def __init__(self, params, cfg, cache, steps: int, width: int, dtype, device, mesh=None):
        super().__init__(params, cfg, cache, dtype, device, mesh)
        self.steps = int(steps)
        self.width = int(width)
        b, s, k = self.batch, self.width, self.steps
        n_stage = b * (s + len(_ROW_FIELDS) + 5)
        self._stage_host = torch.zeros((n_stage,), dtype=torch.int32, pin_memory=self.cuda)
        self._stage = torch.zeros((n_stage,), dtype=torch.int32, device=self.device)
        n_out = b * (k + s + 3)
        self._out = torch.zeros((n_out,), dtype=torch.int32, device=self.device)
        self._out_host = torch.zeros((n_out,), dtype=torch.int32, pin_memory=self.cuda)
        self._event = torch.cuda.Event() if self.cuda else None
        self._staged = torch.cuda.Event() if self.cuda else None
        self._staged_roles = np.zeros((b,), np.int32)
        self._staged_counts = np.zeros((b,), np.int32)

    # -- the call ------------------------------------------------------------

    def _inputs(self) -> dict:
        """The staged inputs, unpacked on the device (inside the graph)."""
        b, s = self.batch, self.width
        st = self._stage
        out = {"ids": st[: b * s].view(b, s).to(torch.int64)}
        o = b * s
        for name in _ROW_FIELDS:
            out[name] = st[o:o + b]
            o += b
        out["active"] = out["active"] != 0
        out["slot_keys"] = st[o:o + 2 * b].view(b, 2).to(torch.int64) & 0xFFFFFFFF
        o += 2 * b
        out["r_temps"] = st[o:o + b].view(torch.float32)
        out["r_tks"] = st[o + b:o + 2 * b]
        out["r_tps"] = st[o + 2 * b:o + 3 * b].view(torch.float32)
        return out

    def _run(self, window: int, sampling: bool) -> None:
        """One super-step and the packed finalize on the static buffers."""
        a = self._inputs()
        sample, carry0 = self._sampler(sampling)
        (logits, tok_block, valid, greedy, accepted, toks2, cache, _, _,
         carry) = llama.super_step_ragged(
            self._params, a["ids"], self.cache, self._cfg, roles=a["roles"],
            offsets=a["offsets"], counts=a["counts"], draft_len=a["draft_len"],
            active=a["active"], remaining=a["remaining"], eos_ids=a["eos_ids"],
            steps=self.steps, sample_fn=sample, sample_carry=carry0, dtype=self._dtype,
            window=window, mesh=self._mesh,
        )
        keys_run = carry if sampling else self.keys
        is_final = a["last_pos"] >= 0
        b, _, vocab = logits.shape
        at = a["last_pos"].clamp(min=0).to(torch.int64)[:, None, None].expand(b, 1, vocab)
        row = torch.gather(logits, 1, at)[:, 0]                   # [B, vocab]
        f_carry, firsts = sample_chain_step(row, a["slot_keys"], a["r_temps"], a["r_tks"],
                                            a["r_tps"])
        self.keys.copy_(torch.where(is_final[:, None], f_carry, keys_run))
        self.temps.copy_(torch.where(is_final, a["r_temps"], self.temps))
        self.topk.copy_(torch.where(is_final, a["r_tks"], self.topk))
        self.topp.copy_(torch.where(is_final, a["r_tps"], self.topp))
        self.lengths.copy_(torch.where(is_final, a["final_lens"], cache.lengths))
        self.tokens.copy_(torch.where(is_final, firsts.to(torch.int64), toks2[:, 0])[:, None])
        self._out.copy_(torch.cat([t.to(torch.int32).reshape(-1) for t in
                                   (tok_block, valid, greedy, accepted, firsts)]))

    def _check_parked(self) -> None:
        if self._staged_roles.any() or self._staged_counts.any():
            raise RuntimeError("capture needs a parked super-step (idle rows, zero counts)")

    # -- a tick --------------------------------------------------------------

    def stage(self, ids, roles, offsets, counts, draft_len, active, remaining, eos_ids,
              last_pos, final_lens, slot_keys, r_temps, r_tks, r_tps) -> None:
        """A tick's host arrays into the pinned staging buffer, then one copy
        to the card.  ``slot_keys`` int ``[B, 2]``: threefry words."""
        b, s = self.batch, self.width
        host = self._stage_host.numpy()
        if self._staged is not None:
            self._staged.synchronize()  # the last stage's copy has left the buffer
        host[: b * s] = np.asarray(ids, np.int64).reshape(b * s)
        o = b * s
        for arr in (roles, offsets, counts, draft_len, active, remaining, eos_ids, last_pos,
                    final_lens):
            host[o:o + b] = np.asarray(arr).astype(np.int32)
            o += b
        host[o:o + 2 * b] = np.asarray(slot_keys, np.int64).reshape(-1).astype(
            np.uint32).view(np.int32)
        o += 2 * b
        host[o:o + b] = np.asarray(r_temps, np.float32).view(np.int32)
        host[o + b:o + 2 * b] = np.asarray(r_tks, np.int32)
        host[o + 2 * b:o + 3 * b] = np.asarray(r_tps, np.float32).view(np.int32)
        self._staged_roles = np.asarray(roles, np.int32).copy()
        self._staged_counts = np.asarray(counts, np.int32).copy()
        self._stage.copy_(self._stage_host, non_blocking=self.cuda)
        if self._staged is not None:
            self._staged.record()

    def dispatch(self, window: int, sampling: bool) -> SuperstepOut:
        """One tick on the staged inputs (:meth:`_replay`), then its
        synchronous readback."""
        self._replay(window, sampling)
        self._out_host.copy_(self._out, non_blocking=self.cuda)
        if self._event is not None:
            self._event.record()
            self._event.synchronize()
        flat = self._out_host.numpy().copy()
        b, s, k = self.batch, self.width, self.steps
        o = 0
        parts = []
        for n, shape in ((b * k, (b, k)), (b, (b,)), (b * s, (b, s)), (b, (b,)), (b, (b,))):
            parts.append(flat[o:o + n].reshape(shape))
            o += n
        return SuperstepOut(*parts)
