"""Design study: per-stripe (chunk-masked) truncation of the last coded
plane — quantifies the CR headroom of replacing the fine-truncation
PREFIX (js, jr) with per-chunk presence MASKS.

Findings on the ERA5 fixture (2026-08-17, this host):

| config            | chosen bits | masked bits | saving |
|-------------------|------------:|------------:|-------:|
| clean max-0.5     |     326,062 |     297,460 |   8.8% |
| noisy max-0.5     |     398,045 |     372,841 |   6.3% |
| clean rel-0.009   |     326,062 |     318,314 |   2.4% |
| clean rel-0.001   |   1,591,776 |  (prefix wins; a real impl floors at 0%) |

Interpretation: the coder's fine chunks are horizontal row-stripes, and
the bit cost of the last coded plane is strongly non-uniform across them
(e.g. 66,571 vs 1,996 bits per stripe on the clean frame).  The uniform
prefix keeps low-value chunks because they come first in scan order; a
per-chunk mask (1-2 bytes of header per layer) lets the encoder keep only
the chunks that matter for the bound.

NOT implemented: the mask breaks the pure prefix property of the stream's
final plane, so it needs coordinated changes in the JAX packer
(ops/bitplane.py scan offsets), BOTH native coders, the CPU/plugin
decoders, the u16 transfer packings and the container — the full
stream-format-invariant surface (CLAUDE.md).  Parked as a round-3
candidate with this script as the evidence base.

Negative result (also measured): reordering the within-plane chunk scan
by a DECODER-DERIVABLE activity metric (significance counts above the
plane) — which would keep the prefix property and need no header bits —
does NOT capture the gain (-5.2% / -0.5% vs the current order): activity
predicts where bits are, not where the bound still NEEDS them.  The mask
must be encoder-signaled.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def main():
    import jax

    from ebcc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from ebcc_tpu.codec.config import EBCCConfig, ResidualMode
    from ebcc_tpu.codec.pipeline import FrameCodec
    from ebcc_tpu.ops import bitplane as bp

    base = np.load("/root/reference/data/test_data.npy").astype(np.float32)
    rng = np.random.default_rng(0)
    noisy = (base + rng.normal(0, 0.05, base.shape)).astype(np.float32)

    def measure(label, frame, mode, err):
        cfg = EBCCConfig(mode=mode, error=err, base_cr=100, max_batch=1)
        codec = FrameCodec(*frame.shape, cfg)
        tgt = (err * (frame.max() - frame.min())
               if mode == ResidualMode.RELATIVE_ERROR else err)
        res = codec.encode_error_bounded(
            jnp.asarray(frame[None]), jnp.full((1,), tgt, jnp.float32), 1e-6)
        an = bp.analyze(jnp.asarray(np.asarray(res.base_coef), jnp.int32),
                        codec.base.spec)
        cand = np.asarray(bp.candidate_bits(
            bp.segment_counts(an, codec.base.spec), codec.base.spec))[0]
        P, K2 = cand.shape
        J = K2 // 2
        bs, ks = int(res.bs_pure[0]), int(res.ks_pure[0])
        pidx = P - 1 - bs
        chosen = int(cand[pidx, ks])
        full_prev = int(cand[pidx - 1, K2 - 1]) if pidx >= 1 else 0
        inc = np.diff(np.concatenate([[full_prev], cand[pidx]]))
        ci = np.asarray(res.base_coef).astype(np.int64)[0]
        stripe = (np.arange(ci.shape[0]) * J) // ci.shape[0]
        recon = jax.jit(
            lambda r: codec._base_recon(r, res.mn, res.mx, res.dc_b))

        def err_at(depths):
            d = np.asarray(depths)[stripe][:, None]
            mag = np.abs(ci)
            kept = (mag >> d) << d
            half = np.where((kept > 0) & (d > 0), (2.0 ** d - 1.0) * 0.5,
                            0.0)
            rec = np.where(kept > 0, kept + half, 0.0) * np.sign(ci)
            out = np.asarray(recon(jnp.asarray(rec[None], jnp.float32)))[0]
            return float(np.abs(out - frame).max())

        depths = [bs] * J
        for j in range(J):
            t = depths.copy()
            t[j] = bs + 1
            if err_at(t) <= tgt:
                depths[j] = bs + 1
        keep = [j for j in range(J) if depths[j] == bs]
        if err_at(depths) <= tgt:
            masked = full_prev + sum(int(inc[j]) + int(inc[J + j])
                                     for j in keep)
            print(f"{label}: chosen {chosen} masked {masked} "
                  f"save {100 * (1 - masked / chosen):.1f}% (kept {keep})")
        else:
            print(f"{label}: combined drop infeasible; masked = prefix")

    measure("clean max-0.5", base, ResidualMode.MAX_ERROR, 0.5)
    measure("noisy max-0.5", noisy, ResidualMode.MAX_ERROR, 0.5)
    measure("clean rel-0.009", base, ResidualMode.RELATIVE_ERROR, 0.009)


if __name__ == "__main__":
    main()
