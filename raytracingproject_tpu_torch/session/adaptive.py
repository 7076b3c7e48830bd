"""Adaptive sampling with a wavefront of fixed width (JAX counterpart:
raytracingproject_tpu/session/adaptive.py: render_adaptive_device :22 and
the host driver render_adaptive :157).

The wavefront keeps its width while the set of unconverged pixels
shrinks: the lanes of converged pixels are handed to pixels that are
still active, as further samples of them. Which pixel a lane renders and
at which sample it starts are tensors, so every round runs the same
ops/integrator.py render_samples_adaptive_chunk.

The error is the half-buffer estimate: beside the sum L of all samples
the chunk returns the sum E of the samples of even index, and a pixel has
converged when sum|L - 2E| / (n * sqrt(mean)) falls below the threshold.

Two drivers: `render_adaptive_device` keeps its state on the render
device and reads one scalar a round; `render_adaptive` plans each round on
the host in numpy (milestones, a waterfill of surplus lanes) and gathers
the lanes' sums there.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from raytracingproject_tpu_torch.ops import integrator as integ


def _active(L_sum, E_sum, counts, spp, min_samples, threshold):
    """Pixels that still want samples: under budget and, with a positive
    threshold, under min_samples or above the error threshold."""
    nz = torch.clamp(counts, min=1)
    mean = L_sum.sum(-1) / nz
    err = (L_sum - 2.0 * E_sum).abs().sum(-1) \
        / (nz * torch.sqrt(torch.clamp(mean, min=1e-4)))
    active = counts < spp
    if threshold > 0.0:
        active = active & ((counts < min_samples) | (err >= threshold))
    return active


def render_adaptive_device(kg, W, H, spp, *, threshold, min_samples=None,
                           chunk=4, lanes=None, max_rounds=None,
                           on_dispatch=None):
    """The adaptive loop with its state on the render device (the device
    of kg's tensors): a round finds the active pixels from the half-buffer
    error, shares the `lanes` (default W * H) among them, renders one
    chunk, and adds the lanes into L, A, E and the counts by pixel id; one
    scalar, the number of pixels still active, is read by the host.

    Active pixels get contiguous, near-even ranges of lanes by rank (the
    first `lanes % active` ranks one more), in closed form per lane.
    Replica r of a pixel renders samples [counts + r * chunk, counts +
    (r + 1) * chunk); a replica that would pass the budget idles. With
    more active pixels than lanes the pixels of highest rank wait for a
    later round. `spp` must be a multiple of `chunk`.

    The loop runs until no pixel is active. `max_rounds` ends it earlier:
    then stats["converged"] is False and stats["n_active"] says how many
    pixels were left (the JAX function stops after (spp / chunk + 8) * 4
    rounds and does not say so).

    Several lanes add into one pixel through index_add_, whose order of
    additions is not fixed on the card: sums can differ in the last bits
    from run to run.

    `on_dispatch(round_wall_s)` is called after each round with its wall
    time on the host clock, the round's one read included.

    Returns (L_sum (W*H, 3), A_sum (W*H,), counts (W*H,) int32, stats) as
    numpy arrays and a dict."""
    npix = W * H
    n = int(lanes or npix)
    if min_samples is None:
        min_samples = max(spp // 8, 8)
    min_samples = max(int(min_samples), 2)
    assert spp % chunk == 0, "spp must be a multiple of chunk"
    thr = float(threshold)
    dev = kg["filter_table"].device
    L_sum = torch.zeros((npix, 3), device=dev)
    A_sum = torch.zeros(npix, device=dev)
    E_sum = torch.zeros((npix, 3), device=dev)
    counts = torch.zeros(npix, dtype=torch.int32, device=dev)
    pix_ids = torch.arange(npix, device=dev)
    lane = torch.arange(n, device=dev)
    active = _active(L_sum, E_sum, counts, spp, min_samples, thr)
    n_active = npix    # every pixel starts under its budget
    rounds = 0
    while n_active > 0 and (max_rounds is None or rounds < max_rounds):
        t0 = time.perf_counter()
        # rank -> pixel (inactive pixels land in a spare last slot)
        rank = torch.cumsum(active, 0) - 1
        r2p = torch.zeros(npix + 1, dtype=torch.int64, device=dev)
        r2p[torch.where(active, rank, npix)] = pix_ids
        # lane -> rank: the first `extra` ranks hold base + 1 lanes
        base = n // n_active
        extra = n - base * n_active
        split = extra * (base + 1)
        in_hi = lane < split
        k_raw = torch.where(in_hi, lane // (base + 1),
                            extra + (lane - split) // max(base, 1))
        start_k = torch.where(in_hi, k_raw * (base + 1),
                              split + (k_raw - extra) * max(base, 1))
        pix = r2p[torch.clamp(k_raw, max=n_active - 1)]
        s0 = counts[pix].long() + (lane - start_k) * chunk
        # k_raw >= n_active only with more active pixels than lanes
        valid = (s0 + chunk <= spp) & (k_raw < n_active)
        L, A, E = integ.render_samples_adaptive_chunk(
            kg, pix % W, pix // W, pix, s0, chunk)
        L_sum.index_add_(0, pix, torch.where(valid[:, None], L, 0.0))
        A_sum.index_add_(0, pix, torch.where(valid, A, 0.0))
        E_sum.index_add_(0, pix, torch.where(valid[:, None], E, 0.0))
        counts.index_add_(0, pix, torch.where(valid, chunk, 0).to(torch.int32))
        # the round's one read by the host
        active = _active(L_sum, E_sum, counts, spp, min_samples, thr)
        n_active = int(active.sum())
        rounds += 1
        if on_dispatch is not None:
            on_dispatch(time.perf_counter() - t0)
    counts_np = counts.cpu().numpy()
    stats = {
        "samples_rendered": int(counts_np.sum()),
        "samples_nominal": npix * spp,
        "dispatches": rounds,
        "lanes_wasted": 0,
        "max_samples": int(counts_np.max()) if npix else 0,
        "min_samples": int(counts_np.min()) if npix else 0,
        "converged": n_active == 0,
        "n_active": n_active,
    }
    return L_sum.cpu().numpy(), A_sum.cpu().numpy(), counts_np, stats


def _chunk_on_device(kg, chunk):
    """render_chunk(px, py, pidx, s0) of numpy lane arrays through
    render_samples_adaptive_chunk on kg's device; numpy (L, A, E) back."""
    dev = kg["filter_table"].device

    def render_chunk(px, py, pidx, s0):
        lane = [torch.as_tensor(np.asarray(a, np.int64), device=dev)
                for a in (px, py, pidx, s0)]
        L, A, E = integ.render_samples_adaptive_chunk(kg, *lane, chunk)
        return L.cpu().numpy(), A.cpu().numpy(), E.cpu().numpy()

    return render_chunk


def render_adaptive(kg, W, H, spp, *, threshold, min_samples=None, chunk=4,
                    lanes=None, render_chunk=None):
    """The adaptive loop planned on the host: W x H pixels with error-driven
    per-pixel sample counts. Returns (L_sum (W*H, 3), A_sum (W*H,), counts
    (W*H,) int64, stats) as numpy arrays and a dict; the image is L_sum /
    counts[:, None].

    A round shares the `lanes` (default W * H) among the active pixels,
    floor or ceil of lanes / active each, capped at the pixel's next
    milestone (min_samples first, then each doubling of its count, at
    most spp) so the error is tested before a wide wavefront spends the
    whole budget. Lanes the caps leave over render further chunks up to
    the budget, the pixels of highest error first (stable order), by a
    waterfill; what is still left repeats scheduled lanes cyclically as
    padding, which the sums drop (stats["lanes_wasted"]). Replica r of a
    pixel renders samples [counts + r * chunk, counts + (r + 1) * chunk).
    After the round a pixel stays active while it is under spp and, with
    a positive threshold, under min_samples or at an error of at least
    the threshold; the loop runs until none is.

    `render_chunk(px, py, pidx, s0)` renders one chunk of numpy lane
    arrays and returns numpy (L (n, 3), A (n,), E (n, 3)); by default
    render_samples_adaptive_chunk on kg's device."""
    npix = W * H
    n = int(lanes or npix)
    if min_samples is None:
        min_samples = max(spp // 8, 8)
    min_samples = max(int(min_samples), 2)
    if render_chunk is None:
        render_chunk = _chunk_on_device(kg, chunk)

    L_sum = np.zeros((npix, 3), np.float32)
    A_sum = np.zeros(npix, np.float32)
    E_sum = np.zeros((npix, 3), np.float32)
    counts = np.zeros(npix, np.int64)
    active = np.arange(npix, dtype=np.int64)
    err_act = None  # each active pixel's error at the last test
    dispatches = 0
    lanes_wasted = 0

    while active.size:
        A = active.size
        R = n // A
        extra = n - R * A
        reps = np.full(A, R, np.int64)
        reps[:extra] += 1
        ca = counts[active]
        milestone = np.where(ca < min_samples, min_samples,
                             np.minimum(np.maximum(ca * 2, ca + chunk), spp))
        cap = np.maximum((milestone - ca + chunk - 1) // chunk, 1)
        reps_c = np.minimum(reps, cap)
        leftover = n - int(reps_c.sum())
        if leftover > 0:
            # surplus lanes render real chunks past the milestone, highest
            # error first: waterfill to the largest level m with
            # sum(min(rem, m)) <= leftover, then one more each in order
            rem = np.maximum((spp - ca) // chunk - reps_c, 0)
            order = (np.argsort(-err_act, kind="stable")
                     if err_act is not None and err_act.size == A
                     else np.arange(A))
            rs = rem[order]
            lo, hi = 0, int(rs.max()) if rs.size else 0
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if int(np.minimum(rs, mid).sum()) <= leftover:
                    lo = mid
                else:
                    hi = mid - 1
            extra_sorted = np.minimum(rs, lo)
            short = leftover - int(extra_sorted.sum())
            if short > 0:
                idxs = np.flatnonzero(rs > lo)[:short]
                extra_sorted[idxs] += 1
            extras = np.zeros(A, np.int64)
            extras[order] = extra_sorted
            reps_c = reps_c + extras
        lane_pix = np.repeat(active, reps_c)
        offs = np.repeat(np.cumsum(reps_c) - reps_c, reps_c)
        rep_idx = np.arange(lane_pix.size, dtype=np.int64) - offs
        pad = n - lane_pix.size
        if pad > 0:
            # the tail repeats scheduled lanes; their sums are dropped
            lanes_wasted += pad
            lane_pix = np.concatenate([lane_pix, np.resize(lane_pix, pad)])
            rep_idx = np.concatenate([rep_idx, np.full(pad, -1)])
        live = rep_idx >= 0
        s0 = counts[lane_pix] + np.maximum(rep_idx, 0) * chunk

        px = (lane_pix % W).astype(np.int32)
        py = (lane_pix // W).astype(np.int32)
        L, Al, E = render_chunk(px, py, lane_pix.astype(np.int32),
                                s0.astype(np.uint32))
        dispatches += 1
        lp = lane_pix[live]
        np.add.at(L_sum, lp, L[live])
        np.add.at(A_sum, lp, Al[live])
        np.add.at(E_sum, lp, E[live])
        np.add.at(counts, active, reps_c * chunk)

        nact = counts[active].astype(np.float64)
        mean = L_sum[active].sum(-1) / np.maximum(nact, 1)
        err = np.abs(L_sum[active] - 2.0 * E_sum[active]).sum(-1) / (
            nact * np.sqrt(np.maximum(mean, 1e-4)))
        keep = counts[active] < spp
        if threshold > 0.0:
            keep &= (counts[active] < min_samples) | (err >= threshold)
        active = active[keep]
        err_act = err[keep]

    stats = {
        "samples_rendered": int(counts.sum()),
        "samples_nominal": npix * spp,
        "dispatches": dispatches,
        "lanes_wasted": int(lanes_wasted),
        "max_samples": int(counts.max()) if npix else 0,
        "min_samples": int(counts.min()) if npix else 0,
    }
    return L_sum, A_sum, counts, stats
