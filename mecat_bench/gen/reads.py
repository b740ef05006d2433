"""Simulated long reads from a seed, vectorised.

The semantics of a plain long-read simulator: a random genome; read lengths
drawn from an exponential of mean ``mean_len - min_len`` shifted by
``min_len`` and clipped to the genome; a uniform start and strand; then each
base of the read's true sequence is substituted with probability ``sub``
(to one of the three other bases), else deleted with probability ``dele``,
and followed by one random inserted base with probability ``ins`` unless it
was deleted.  ``sub``, ``ins``, ``dele`` are the error rate split by the
profile's shares.

Every seed gets the same set of read lengths, drawn once from
``LENGTH_SEED``, in an order of its own: the work a window meets depends on
the lengths, and the seed is to change the reads, not the amount of work.
Everything else (the genome, the order of the lengths, starts, strands,
errors) comes from one ``torch.Generator`` seeded with the run's seed.  It
runs in a few large torch calls on ``device``, in chunks of about
``CHUNK_BASES`` true bases, so a card makes 365 Mb in a few seconds.  The
same seed on the same device gives the same reads.

Besides the reads, each read keeps its truth: genome start, end, strand,
and the map from its true bases (in read orientation) to read positions
(a deleted base maps to the position of the next read base), from which
the correction cell derives its candidate records.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

CHUNK_BASES = 1 << 26
#: seed of the read-length set every run shares
LENGTH_SEED = 20170512


@dataclass
class SimReads:
    codes: np.ndarray       # uint8 [total], read bases 0..3 (A C G T)
    starts: np.ndarray      # int64 [n] offset of each read in codes
    lengths: np.ndarray     # int32 [n]
    g_start: np.ndarray     # int64 [n] genome start of the true sequence
    g_len: np.ndarray       # int64 [n] true length on the genome
    strand: np.ndarray      # int8 [n] 0 forward, 1 reverse complement
    #: int32 [sum g_len] read position of each true base, read orientation
    #: (true base k of read r is map_out[map_starts[r] + k]); None unless
    #: asked for
    map_out: Optional[np.ndarray] = None
    map_starts: Optional[np.ndarray] = None
    genome_size: int = 0

    @property
    def n_reads(self) -> int:
        return len(self.lengths)

    def read_pos(self, r: int, g: np.ndarray) -> np.ndarray:
        """Read positions of genome positions ``g`` (inside read r's true
        interval), in the read's own orientation."""
        k = (g - self.g_start[r] if self.strand[r] == 0
             else self.g_start[r] + self.g_len[r] - 1 - g)
        return self.map_out[self.map_starts[r] + k]


def release(device) -> None:
    """Drop the generator's temporaries from the device's cache and start
    the peak-memory count afresh: the inputs are not the program's."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def profile_rates(error_rate: float, profile) -> tuple:
    """(sub, ins, dele) probabilities of the error profile."""
    sub, ins, dele = (error_rate * float(f) for f in profile)
    return sub, ins, dele


def simulate(cfg: dict, seed: int, device, keep_map: bool = False
             ) -> SimReads:
    """Reads of configuration ``cfg`` (keys ``genome_size``, ``coverage``,
    ``mean_len``, ``min_len``, ``error_rate``, ``profile``) from ``seed``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    G = int(cfg["genome_size"])
    mean_len, min_len = int(cfg["mean_len"]), int(cfg["min_len"])
    n = int(round(float(cfg["coverage"]) * G / mean_len))
    sub, ins, dele = profile_rates(cfg["error_rate"], cfg["profile"])

    genome = torch.randint(0, 4, (G,), generator=g, device=device,
                           dtype=torch.uint8)
    g_len = torch.Generator(device=device)
    g_len.manual_seed(LENGTH_SEED)
    e = torch.empty(n, dtype=torch.float64, device=device).exponential_(
        1.0 / max(1, mean_len - min_len), generator=g_len)
    lens = (e + min_len).floor().clamp(min_len, max(min_len, G)).long()
    lens = lens.clamp(max=G)[torch.randperm(n, generator=g, device=device)]
    u = torch.rand(n, dtype=torch.float64, device=device, generator=g)
    g_start = (u * (G - lens + 1).clamp(min=1)).floor().long()
    strand = torch.randint(0, 2, (n,), generator=g, device=device)

    codes, out_lens, maps = [], [], []
    r0 = 0
    cum = torch.cumsum(lens, 0).cpu().numpy()
    while r0 < n:
        base_at = (cum[r0 - 1] if r0 else 0)
        r1 = int(np.searchsorted(cum, base_at + CHUNK_BASES, side="right"))
        r1 = max(r1, r0 + 1)
        c, ol, m = _mutate_chunk(genome, lens[r0:r1], g_start[r0:r1],
                                 strand[r0:r1], sub, ins, dele, g, keep_map)
        codes.append(c)
        out_lens.append(ol)
        if keep_map:
            maps.append(m)
        r0 = r1
    lengths = np.concatenate(out_lens).astype(np.int32)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    glen = lens.cpu().numpy().astype(np.int64)
    sim = SimReads(codes=np.concatenate(codes), starts=starts,
                   lengths=lengths, g_start=g_start.cpu().numpy(),
                   g_len=glen, strand=strand.cpu().numpy().astype(np.int8),
                   genome_size=G)
    if keep_map:
        sim.map_out = np.concatenate(maps)
        sim.map_starts = np.zeros(n, dtype=np.int64)
        np.cumsum(glen[:-1], out=sim.map_starts[1:])
    return sim


def _mutate_chunk(genome, lens, g_start, strand, sub, ins, dele, g,
                  keep_map):
    """Reads of one chunk: (codes uint8, lengths int64, map int32 or
    None), all NumPy."""
    dev = genome.device
    m = lens.shape[0]
    total = int(lens.sum())
    rid = torch.repeat_interleave(torch.arange(m, device=dev), lens,
                                  output_size=total)
    src0 = torch.cumsum(lens, 0) - lens
    k = torch.arange(total, device=dev) - src0[rid]
    fwd = strand[rid] == 0
    gpos = torch.where(fwd, g_start[rid] + k, g_start[rid] + lens[rid] - 1 - k)
    base = genome[gpos]
    base = torch.where(fwd, base, 3 - base)
    r = torch.rand(total, device=dev, generator=g)
    r2 = torch.rand(total, device=dev, generator=g)
    shift = torch.randint(1, 4, (total,), device=dev, generator=g,
                          dtype=torch.uint8)
    is_sub = r < sub
    base = torch.where(is_sub, (base + shift) % 4, base)
    is_del = (r2 >= sub) & (r2 < sub + dele) & ~is_sub
    is_ins = (r2 >= sub + dele) & (r2 < sub + dele + ins) & ~is_del
    cnt = (~is_del).long() + is_ins.long()
    pos = torch.cumsum(cnt, 0) - cnt
    n_out = int(cnt.sum())
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    keep = ~is_del
    out[pos[keep]] = base[keep]
    ins_pos = pos[is_ins] + 1
    out[ins_pos] = torch.randint(0, 4, (ins_pos.shape[0],), device=dev,
                                 generator=g, dtype=torch.uint8)
    out_len = torch.zeros(m, dtype=torch.long, device=dev)
    out_len.index_add_(0, rid, cnt)
    mp = None
    if keep_map:
        out0 = torch.cumsum(out_len, 0) - out_len
        mp = (pos - out0[rid]).to(torch.int32).cpu().numpy()
    return out.cpu().numpy(), out_len.cpu().numpy(), mp
