"""Kernel K3: the split-read vote's sequential greedy register scan.

`vote_state` replaces localhgt_tpu/ops/pallas_vote.py::vote_state. It runs
the CUDA kernel of `csrc/vote.cu` for CUDA tensors and `vote_state_plain`
(the lax.scan body of localhgt_tpu/pipeline/peaks.py::_vote_core over
[B, G] tensors) for CPU tensors, and raises on anything else. Launches
are counted in `vote_state.launches`. What bounds the kernel on an H100
is in the header of csrc/vote.cu.
"""

from __future__ import annotations

import ctypes

import torch

from localhgt_tpu_torch import _build

_P = ctypes.c_void_p
SIGNATURE = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P]
KERNEL_SLOTS = 8  # the register size the CUDA kernel is built for
KERNEL_MAX_HASHES = 9  # C it is instantiated for (config: 1-9)


def vote_state_plain(genome: torch.Tensor, pk: torch.Tensor,
                     n_slots: int = 8):
    """Plain torch version of K3: one position at a time over [B, G]."""
    C, B, P = pk.shape
    G = n_slots
    dev = pk.device
    z = torch.zeros((B, G), dtype=torch.int32, device=dev)
    sg, sc, sp, st = z.clone(), z.clone(), z.clone(), z.clone()
    hits = torch.zeros(B, dtype=torch.int32, device=dev)
    slot = torch.arange(G, device=dev)[None, :]
    for p in range(P):
        sel_g = torch.zeros(B, dtype=torch.int32, device=dev)
        sel_cnt = torch.zeros_like(sel_g)
        sel_p = torch.zeros_like(sel_g)
        for c in range(C):
            g = genome[c, :, p]
            pc = pk[c, :, p]
            is_cand = pc != 0
            match = (sg == g[:, None]) & (sg != 0)
            seen = match.any(dim=1)
            cnt = torch.where(match, sc, 0).amax(dim=1)
            take_seen = is_cand & seen & (cnt >= sel_cnt)
            take_new = is_cand & ~seen & (sel_p == 0)
            take = take_seen | take_new
            sel_g = torch.where(take, g, sel_g)
            sel_cnt = torch.where(take_seen, cnt,
                                  torch.where(take_new, 0, sel_cnt))
            sel_p = torch.where(take, pc, sel_p)
        do = sel_p != 0
        match = (sg == sel_g[:, None]) & (sg != 0)
        have = match.any(dim=1)
        sc = sc + (match & do[:, None]).to(torch.int32)
        empty = sg == 0
        count1 = (sg != 0) & (sc == 1)
        has_empty = empty.any(dim=1, keepdim=True)
        tc1 = torch.where(count1, st, -1)
        mru = count1 & (tc1 == tc1.amax(dim=1, keepdim=True))
        victim = torch.where(has_empty, empty, mru)
        # first victim slot: lowest index among the candidates
        first = torch.where(victim, slot, G).amin(dim=1, keepdim=True)
        ins = (slot == first) & (do & ~have)[:, None]
        sg = torch.where(ins, sel_g[:, None], sg)
        sc = torch.where(ins, 1, sc)
        sp = torch.where(ins, sel_p[:, None], sp)
        st = torch.where(ins, p + 1, st)
        hits = hits + do.to(torch.int32)
    return sg, sc, sp, hits


def vote_state(genome: torch.Tensor, pk: torch.Tensor, n_slots: int = 8):
    """K3. genome, pk: int32 [C, B, P] candidate genome / peak id per hash
    function, pair and concatenated mate position (0 = none).

    Returns (slots_g, slots_c, slots_p int32 [B, G], hits int32 [B])."""
    if genome.shape != pk.shape or pk.dim() != 3:
        raise ValueError(f"vote_state: want two [C, B, P] tensors, got "
                         f"{tuple(genome.shape)} and {tuple(pk.shape)}")
    if genome.dtype != torch.int32 or pk.dtype != torch.int32:
        raise TypeError("vote_state: want int32 genome and pk")
    if genome.device != pk.device:
        raise ValueError("vote_state: genome and pk on different devices")
    if pk.device.type == "cpu":
        return vote_state_plain(genome, pk, n_slots)
    if pk.device.type != "cuda":
        raise ValueError(f"vote_state: unsupported device {pk.device}")
    if n_slots != KERNEL_SLOTS:
        raise ValueError(f"vote_state: the CUDA kernel has {KERNEL_SLOTS} "
                         f"slots, not {n_slots}")
    if pk.shape[0] > KERNEL_MAX_HASHES:
        raise ValueError(f"vote_state: the CUDA kernel takes at most "
                         f"{KERNEL_MAX_HASHES} hash functions, not "
                         f"{pk.shape[0]}")
    out = launch(_build.load("vote", {"lht_vote_state": SIGNATURE}),
                 genome, pk)
    vote_state.launches += 1
    return out


def launch(lib, genome: torch.Tensor, pk: torch.Tensor):
    """Launch `lht_vote_state` of a loaded library on CUDA tensors. The
    kernel reads the [C, B, P] layout as it is: no transposed copy."""
    C, B, P = pk.shape
    cg = genome.contiguous()
    cp = pk.contiguous()
    dev = pk.device
    og = torch.empty((B, KERNEL_SLOTS), dtype=torch.int32, device=dev)
    oc = torch.empty_like(og)
    op = torch.empty_like(og)
    oh = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # a launch goes to the current device
        err = lib.lht_vote_state(
            cg.data_ptr(), cp.data_ptr(), og.data_ptr(), oc.data_ptr(),
            op.data_ptr(), oh.data_ptr(), B, P, C, KERNEL_SLOTS,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lht_vote_state")
    return og, oc, op, oh


vote_state.launches = 0
