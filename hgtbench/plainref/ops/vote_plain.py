"""Plain torch version of the port's kernel K3 (`vote_state_plain`), the
split-read vote's sequential greedy register scan, frozen here as the
benchmark's reference.
"""

from __future__ import annotations

import torch


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
