"""Adaptive sampling with a wavefront of fixed width (JAX counterpart:
raytracingproject_tpu/session/adaptive.py render_adaptive_device :22).

The wavefront keeps its width while the set of unconverged pixels
shrinks: the lanes of converged pixels are handed to pixels that are
still active, as further samples of them. Which pixel a lane renders and
at which sample it starts are tensors, so every round runs the same
ops/integrator.py render_samples_adaptive_chunk.

The error is the half-buffer estimate: beside the sum L of all samples
the chunk returns the sum E of the samples of even index, and a pixel has
converged when sum|L - 2E| / (n * sqrt(mean)) falls below the threshold.

The host-side loop `render_adaptive` of the JAX module (lane buffers
gathered and scattered in numpy) is not ported.
"""

from __future__ import annotations

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
                           chunk=4, lanes=None, max_rounds=None):
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
