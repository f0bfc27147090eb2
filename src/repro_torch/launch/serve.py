"""Batched LM serving: continuous-batching prefill + decode loop.

The port's counterpart of ``repro.launch.serve``: requests arrive with
prompts, get prefilled into per-slot KV/state caches (an encoder-decoder
also encodes the stub's frame embeddings, zeros at half the prompt's
length and at least 4), and a fixed-width decode
batch greedily samples until each request hits its token budget.  Slot
reuse = continuous batching (new requests take freed slots between decode
steps).  It runs eager on the card (no ``torch.compile``, no CUDA graph),
or on the CPU where ``device="cpu"`` is named.

Usage::

    python -m repro_torch.launch.serve --arch mistral-nemo-12b --smoke
    python -m repro_torch.launch.serve --arch xlstm-125m --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.graphs.structs import DeviceLike
from repro_torch.models.model import build_model
from repro_torch.serving.primitives import BoundedQueue, SlotPool


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # int32 tokens
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Slot-based continuous batching on top of prefill/decode_step.

    Each request is prefilled alone into its slot's cache (batch 1,
    ``max_len`` positions) and decoded slot by slot, as the reference's
    server does.  Admission and slot management use the shared serving
    primitives (``repro_torch.serving.primitives``), in the reference's
    order: the lowest free slot takes the next queued request, a request
    retires as soon as it has its tokens, and freed slots are refilled
    after each round of decode steps.

    ``params`` is a parameter tree in the reference's layout (for example
    ``interop.lm_params_from_numpy``'s); without one, the weights are
    drawn from a generator seeded with ``rng_seed`` on the server's
    device.  ``device`` defaults to the card and raises without one.
    """

    def __init__(self, config, params=None, *, n_slots: int = 4,
                 max_len: int = 256, rng_seed: int = 0,
                 device: DeviceLike = None):
        self.config = config
        self.model = build_model(config, device=device)
        self.device = self.model.device
        if params is None:
            generator = torch.Generator(device=self.device)
            params = self.model.init(generator.manual_seed(rng_seed))
        else:
            params = self.model.load_params(params)
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len

    # -- single-request prefill -> slot cache ------------------------------
    def _prefill_one(self, req: Request):
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self.device)[None, :]
        batch = {"tokens": tokens}
        if self.config.frontend == "patch_stub":
            n = min(self.config.n_frontend_tokens, tokens.shape[1])
            batch["patch_embeds"] = torch.zeros(
                (1, n, self.config.d_model), dtype=torch.float32,
                device=self.device)
        if self.config.frontend == "audio_stub":
            batch["frame_embeds"] = torch.zeros(
                (1, max(tokens.shape[1] // 2, 4), self.config.d_model),
                dtype=torch.float32, device=self.device)
        logits, cache = self.model.prefill(self.params, batch,
                                           max_len=self.max_len)
        next_tok = int(torch.argmax(logits[0, -1]))
        return next_tok, cache

    @torch.inference_mode()
    def serve(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Run all requests to completion; returns rid -> generated tokens."""
        admission = BoundedQueue(name="admission")   # serve-to-completion
        for req in requests:
            admission.put(req)
        slots = SlotPool(self.n_slots)
        active: List[Optional[Request]] = [None] * self.n_slots
        caches: List[Any] = [None] * self.n_slots

        def retire(s: int) -> None:
            active[s].done = True
            active[s] = caches[s] = None
            slots.release(s)

        def admit():
            # freed decode slots take the next queued request (continuous
            # batching): acquire hands out the lowest free slot until the
            # pool or the queue is exhausted
            while len(admission):
                s = slots.acquire()
                if s is None:
                    return
                req = admission.get_nowait()
                tok, cache = self._prefill_one(req)
                req.out_tokens.append(tok)
                active[s], caches[s] = req, cache
                if len(req.out_tokens) >= req.max_new_tokens:
                    retire(s)

        admit()
        while slots.n_busy or len(admission):
            # decode over the occupied slots, one slot's cache at a time
            for s in range(self.n_slots):
                req = active[s]
                if req is None:
                    continue
                last = torch.tensor([[req.out_tokens[-1]]], dtype=torch.int64,
                                    device=self.device)
                logits, caches[s] = self.model.decode_step(
                    self.params, last, caches[s])
                tok = int(torch.argmax(logits[0, -1]))
                req.out_tokens.append(tok)
                if len(req.out_tokens) >= req.max_new_tokens:
                    retire(s)
            admit()
        return {r.rid: r.out_tokens for r in requests}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    config = arch.smoke_config() if args.smoke else arch.config
    server = BatchedServer(config, n_slots=args.slots,
                           max_len=args.prompt_len + args.max_new,
                           device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, config.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    out = server.serve(reqs)
    if server.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    where = (torch.cuda.get_device_name(server.device)
             if server.device.type == "cuda" else "cpu")
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s) on {where}")
    for rid, toks in sorted(out.items()):
        print(f"  req {rid}: {toks}")


if __name__ == "__main__":
    main()
