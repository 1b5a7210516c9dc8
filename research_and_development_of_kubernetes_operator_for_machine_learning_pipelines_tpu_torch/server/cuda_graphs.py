"""The fused K-step decode program: ``llama.decode_multistep`` on static
buffers, replayed from one captured CUDA graph per variant on the card.

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
- **No fallback.**  A capture or a replay that fails on the card raises.
  On the CPU (the tests, ``device='cpu'``) the program runs the same call
  eagerly on the same buffers, which exercises everything but the graph.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import llama
from ..models.sampling import sample_chain_step
from ..ops import decode_attention, flash_attention, rmsnorm, sample_step

# The modules whose ``launches`` counters a replay advances.
_COUNTERS = (decode_attention, rmsnorm, flash_attention, sample_step)


class MultistepProgram:
    """``steps`` decode iterations on static buffers over ``cache``."""

    def __init__(self, params, cfg, cache, steps: int, dtype, device):
        self._params = params
        self._cfg = cfg
        self.steps = int(steps)
        self._dtype = dtype
        self.device = torch.device(device)
        b = int(cache.lengths.shape[0])
        dev = self.device
        self.tokens = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.eos_ids = torch.full((b,), -1, dtype=torch.int32, device=dev)
        self.keys = torch.zeros((b, 2), dtype=torch.int64, device=dev)
        self.temps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.topk = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.topp = torch.ones((b,), dtype=torch.float32, device=dev)
        self.tok_block = torch.zeros((b, self.steps), dtype=torch.int64, device=dev)
        self.valid = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.cache = cache._replace(lengths=self.lengths)
        cuda = dev.type == "cuda"
        # Two host buffers for the lag-1 readback, each with its event.
        self._host = [
            (torch.zeros((b, self.steps), dtype=torch.int64, pin_memory=cuda),
             torch.zeros((b,), dtype=torch.int32, pin_memory=cuda),
             torch.cuda.Event() if cuda else None)
            for _ in range(2)
        ]
        self._flip = 0
        # (window, sampling) -> (graph, {counter module: launches a replay})
        self.graphs: dict[tuple[int, bool], tuple] = {}
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.capture_s = 0.0
        self.replays = 0

    # -- the call ------------------------------------------------------------

    def _run(self, window: int, sampling: bool) -> None:
        """One ``decode_multistep`` on the static buffers, its outputs into
        the output buffers and its chained state back into the inputs."""
        if sampling:
            def sample(logits, carry):
                return sample_chain_step(logits, carry, self.temps, self.topk, self.topp)
            carry0 = self.keys
        else:
            def sample(logits, carry):
                return carry, torch.argmax(logits, dim=-1)
            carry0 = None
        tok_block, valid, toks, cache, act, rem, carry = llama.decode_multistep(
            self._params, self.tokens, self.cache, self._cfg, self.active, self.remaining,
            self.eos_ids, self.steps, sample, sample_carry=carry0, dtype=self._dtype,
            window=window,
        )
        self.tok_block.copy_(tok_block)
        self.valid.copy_(valid)
        self.tokens.copy_(toks)
        self.lengths.copy_(cache.lengths)
        self.active.copy_(act)
        self.remaining.copy_(rem)
        if sampling:
            self.keys.copy_(carry)

    # -- capture -------------------------------------------------------------

    def capture(self, windows) -> None:
        """Capture one graph per (window, sampling mode).  The rows must be
        all inactive with no budget (nothing advances, every write parks);
        the keys are restored after the warm-up runs, which split them."""
        if self.device.type != "cuda":
            return
        if bool(self.active.any()):
            raise RuntimeError("capture needs all-inactive rows")
        counters = _COUNTERS
        keys0 = self.keys.clone()
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
                before = [m.launches for m in counters]
                graph = torch.cuda.CUDAGraph()
                # thread_local: another engine's scheduler thread in this
                # process may use the card while this one captures.
                with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                    self._run(int(window), sampling)
                deltas = {}
                for m, n0 in zip(counters, before):
                    deltas[m] = m.launches - n0
                    m.launches = n0  # a capture launches nothing
                self.graphs[(int(window), bool(sampling))] = (graph, deltas)
        self.keys.copy_(keys0)
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0

    def drop(self) -> None:
        """Forget every graph (the cache they point at is being freed)."""
        self.graphs.clear()

    def pool_bytes(self) -> int:
        """Bytes the graphs' private pool holds on the card."""
        if self.pool is None:
            return 0
        stats = torch.cuda.memory.memory_snapshot()
        return sum(seg["total_size"] for seg in stats
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))

    # -- burst ---------------------------------------------------------------

    def load(self, tokens, lengths, keys, temps, topk, topp, active_np, remaining_np,
             eos_np) -> None:
        """Burst entry: the engine's state into the static buffers."""
        self.tokens.copy_(tokens)
        self.lengths.copy_(lengths)
        self.keys.copy_(keys)
        self.temps.copy_(temps)
        self.topk.copy_(topk)
        self.topp.copy_(topp)
        self.active.copy_(torch.from_numpy(np.asarray(active_np, bool)))
        self.remaining.copy_(torch.from_numpy(np.asarray(remaining_np, np.int32)))
        self.eos_ids.copy_(torch.from_numpy(np.asarray(eos_np, np.int32)))

    def dispatch(self, window: int, sampling: bool) -> int:
        """One fused tick: a graph replay on the card, the eager call on the
        CPU; then the outputs' copy into a host buffer.  Returns the
        buffer's index for :meth:`harvest`."""
        key = (int(window), bool(sampling))
        if self.device.type == "cuda":
            graph, deltas = self.graphs[key]  # a missing variant raises: no eager fallback
            graph.replay()
            for m, n in deltas.items():
                m.launches += n
        else:
            self._run(*key)
        self.replays += 1
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
