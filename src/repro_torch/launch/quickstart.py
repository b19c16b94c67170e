"""Quickstart: Ball Sparse Attention on a random point cloud, a padded batch
of ragged clouds, and the packed-varlen layout, through ``repro_torch.core``
alone.

    python -m repro_torch.launch.quickstart                 # on the card
    python -m repro_torch.launch.quickstart --device cpu

    torchrun --nproc_per_node=2 -m repro_torch.launch.quickstart  # + section 7

The port's analogue of ``examples/quickstart.py`` (fp32, 4 heads of 16).
On the card the default backend (``"auto"``) runs the CUDA kernels:
``bta_fwd``, ``flash_fwd``, ``selection_fwd`` and ``epilogue_fwd``, and
``varlen_fwd`` for the packed layout; on the CPU the reference.  Section 5
swaps the ``reference`` and ``kernels`` backends with no change at the call
site.  Section 7 runs the same call on the ``"sharded"`` backend over a
mesh of two ranks, and only under an initialised group of two (``torchrun``
starts one: NCCL with a card a rank, gloo on the CPU).  Its asserts are the
example's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (BSAConfig, bsa_attention, bsa_attention_varlen, bsa_init,
                              build_balltree_permutation, pack_varlen, ragged_ball_order,
                              unpack_ragged, unpack_varlen, use_backend)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)

    # 1. a point cloud (unordered!) and its features
    rng = np.random.default_rng(0)
    N, d_feat = 2048, 64
    points = rng.standard_normal((N, 3)).astype(np.float32)
    feats = rng.standard_normal((N, d_feat)).astype(np.float32)

    # 2. impose regularity: ball-tree order, so balls are contiguous chunks
    cfg = BSAConfig(ball_size=256, cmp_block=8, top_k=4, group_size=8)
    perm = build_balltree_permutation(points, cfg.ball_size)
    x = torch.from_numpy(feats[perm][None]).to(dev)              # (1, N, d)

    # 3. q/k/v projections (here: random) + BSA
    g = torch.Generator(device=dev).manual_seed(0)
    H, D = 4, 16
    params = bsa_init(cfg, n_heads=H, n_kv_heads=H, head_dim=D, d_model=d_feat,
                      generator=g, device=dev)
    wq, wk, wv = (torch.randn((d_feat, H * D), generator=g, device=dev) * 0.1
                  for _ in range(3))
    q, k, v = ((x @ w).reshape(1, N, H, D) for w in (wq, wk, wv))
    with torch.no_grad():
        out, aux = bsa_attention(params, q, k, v, cfg=cfg, return_aux=True)
    print("BSA output:", tuple(out.shape))
    print("branches:", {b: tuple(aux[b].shape) for b in ("ball", "cmp", "slc")})
    print("selected blocks for group 0, head 0:", aux["indices"][0, 0, 0].tolist())
    print("gates (σ(γ)):", {b: float(gate.mean()) for b, gate in aux["gates"].items()})
    pairs_full = N * N
    pairs_bsa = N * cfg.ball_size + N * (N // cfg.cmp_block) + N * cfg.top_k * cfg.slc_block
    print(f"attended pairs: full {pairs_full:.2e}  bsa {pairs_bsa:.2e} "
          f"({pairs_full / pairs_bsa:.1f}x sparser)")

    # 4. ragged batching: three clouds of different sizes → one padded batch.
    #    Each cloud gets its own ball tree; padding is masked keys, so the
    #    batched result equals running every cloud alone.
    sizes = (1500, 2048, 900)
    clouds = [rng.standard_normal((n, 3)).astype(np.float32) for n in sizes]
    cfeats = [rng.standard_normal((n, d_feat)).astype(np.float32) for n in sizes]
    _, fts, mask, _ = ragged_ball_order(clouds, cfeats, cfg.ball_size)
    B, L = mask.shape
    xb = torch.from_numpy(fts).to(dev)
    qb, kb, vb = ((xb @ w).reshape(B, L, H, D) for w in (wq, wk, wv))
    tmask = torch.from_numpy(mask).to(dev)
    with torch.no_grad():
        out_b = bsa_attention(params, qb, kb, vb, cfg=cfg, mask=tmask)
        # cloud 0: 1500 real rows and 548 masked padding rows, so this holds
        # only if key masking works
        solo = bsa_attention(params, qb[0:1], kb[0:1], vb[0:1], cfg=cfg, mask=tmask[0:1])
    per_cloud = unpack_ragged(out_b.cpu().numpy(), mask)
    print("ragged batch:", {f"cloud{i}": o.shape for i, o in enumerate(per_cloud)},
          f"padded as {tuple(out_b.shape)}")
    assert torch.allclose(out_b[0], solo[0], atol=1e-5)
    print("batched == per-sample (padded cloud): OK")

    # 5. named backends: the same call on another engine, no change at the
    #    call site (REPRO_TORCH_ATTENTION_BACKEND=... does it process-wide)
    qs, ks, vs = q[:, :512], k[:, :512], v[:, :512]
    with torch.no_grad():
        with use_backend("reference"):
            out_ref = bsa_attention(params, qs, ks, vs, cfg=cfg)
        with use_backend("kernels"):        # the CUDA kernels (their plain versions on CPU)
            out_kern = bsa_attention(params, qs, ks, vs, cfg=cfg)
    assert torch.allclose(out_ref, out_kern, atol=1e-3)
    print("backend swap reference ↔ kernels: same result, zero call-site changes")

    # 6. packed-varlen: the same clouds with no dummy batch slots, all on one
    #    axis with per-sample boundaries in ``offsets`` (ball multiples)
    ordered = [fts[i][mask[i]] for i in range(B)]
    tight = sum(-(-len(o) // cfg.ball_size) * cfg.ball_size for o in ordered)
    packed, offsets, maskv = pack_varlen(ordered, cfg.ball_size, pad_to=tight)
    T = packed.shape[0]
    xv = torch.from_numpy(packed).to(dev)
    qv, kv, vv = ((xv @ w).reshape(T, H, D) for w in (wq, wk, wv))
    with torch.no_grad():
        out_vl = bsa_attention_varlen(params, qv, kv, vv, cfg=cfg, offsets=offsets,
                                      mask=torch.from_numpy(maskv).to(dev))
    per_cloud_vl = unpack_varlen(out_vl.cpu().numpy(), offsets, maskv)
    print(f"packed-varlen: {T} rows vs {B * L} bucket-padded "
          f"(offsets {offsets.tolist()})")
    for got, want in zip(per_cloud_vl, per_cloud):
        assert np.allclose(got, want, atol=1e-4)
    print("packed-varlen == bucket-padded, per cloud: OK")
    result = {"out": out, "padded": out_b, "packed": out_vl}

    # 7. several ranks: the "sharded" backend splits the same call over a
    #    mesh of ranks (balls split across them, the small compressed K/V is
    #    used whole), still with no call-site change
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() == 2):
        print("section 7 (the sharded backend) runs under an initialised group of two "
              "ranks: torchrun --nproc_per_node=2 -m repro_torch.launch.quickstart")
        return result
    from repro_torch.distributed import mesh_context
    from repro_torch.launch.mesh import make_local_mesh
    with torch.no_grad(), mesh_context(make_local_mesh()), use_backend("sharded"):
        out_sh = bsa_attention(params, qs, ks, vs, cfg=cfg)
    assert torch.allclose(out_ref, out_sh, atol=1e-4)
    print("sharded over 2 ranks == single-device: OK")
    result["sharded"] = out_sh
    return result


if __name__ == "__main__":
    import os
    if "WORLD_SIZE" in os.environ:                   # started by torchrun
        import torch.distributed as dist
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo")
        try:
            main()
        finally:
            dist.destroy_process_group()
    else:
        main()
