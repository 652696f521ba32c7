"""All-views score grid: the Triton kernel (interpret mode) and the
XLA reference against each other and the chunked parity path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from densepoints.core import Cameras
from densepoints.ops.allview import (
    _slots_per_program,
    allview_scores_triton,
    allview_scores_xla,
    make_plan,
)
from densepoints.pmvs.optimize import patch_ncc_scores
from tests.synthetic import TexturedPlaneScene


def _setup(rng, num_views=5, width=200, height=160):
    scene = TexturedPlaneScene(rng, num_views=num_views, width=width, height=height)
    cams = Cameras.from_projection_matrices(
        scene.P, widths=scene.width, heights=scene.height
    )
    images = jnp.asarray(scene.render_all())
    return scene, cams, images


def _patches(cams, rng, n, mixed=False):
    xy = rng.uniform(-0.5, 0.5, (n, 2))
    position = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    normal = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    V = cams.num_views
    if mixed:
        refs = rng.integers(0, V, (n,)).astype(np.int32)
        vis = rng.uniform(size=(n, V)) > 0.3
        vis[np.arange(n), refs] = False
        vis[0] = False  # a patch with no visible views at all
    else:
        refs = np.zeros((n,), np.int32)
        vis = np.ones((n, V), bool)
        vis[:, 0] = False
    return (
        jnp.asarray(position),
        jnp.asarray(normal),
        jnp.asarray(refs),
        jnp.asarray(vis),
    )


def test_make_plan_invariants(rng):
    B, V = 13, 5
    mask = rng.uniform(size=(B, V)) > 0.4
    mask[3] = False  # a patch with no visibility
    plan = make_plan(jnp.asarray(mask))
    anchor = np.argmax(mask, axis=1)
    payload = mask & (np.arange(V)[None, :] != anchor[:, None])
    np.testing.assert_array_equal(np.asarray(plan.anchor), anchor)
    np.testing.assert_array_equal(np.asarray(plan.has), mask.any(axis=1))
    np.testing.assert_array_equal(np.asarray(plan.payload), payload)
    slots = np.asarray(plan.slots)
    n = int(np.asarray(plan.count)[0])
    # Every payload slot exactly once, view-major (v * B + b) ascending,
    # then -1 padding up to whole programs.
    want = np.nonzero(payload.T.reshape(-1))[0]
    assert n == len(want)
    np.testing.assert_array_equal(slots[:n], want)
    assert np.all(slots[n:] == -1)
    assert len(slots) % _slots_per_program(11) == 0
    assert len(slots) % _slots_per_program(16) == 0
    # The inverse finds each payload slot's position.
    inv = np.asarray(plan.inv)
    np.testing.assert_array_equal(slots[inv[want]], want)


def test_xla_allviews_matches_chunked_slots(rng):
    """The (B, V) score grid must agree with the existing compacted-slot
    XLA path (pmvs.optimize.patch_ncc_scores) wherever both score."""
    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 10)
    grid, anchor, aok = allview_scores_xla(
        images, cams, pos, nrm, refs, vis, 11
    )
    slot_scores, view_ids, ok = patch_ncc_scores(
        images, cams, pos, nrm, refs, vis, 11
    )
    grid = np.asarray(grid)
    slot_scores = np.asarray(slot_scores)
    view_ids = np.asarray(view_ids)
    ok = np.asarray(ok)
    for b in range(grid.shape[0]):
        for m in range(1, view_ids.shape[1]):  # slot 0 = anchor
            if ok[b, m]:
                np.testing.assert_allclose(
                    grid[b, view_ids[b, m]],
                    slot_scores[b, m],
                    rtol=1e-4,
                    atol=1e-4,
                )


def test_paged_matches_xla_allviews(rng):
    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 12)
    ref_grid, ref_anchor, ref_aok = allview_scores_xla(
        images, cams, pos, nrm, refs, vis, 11
    )
    grid, anchor, aok = allview_scores_triton(
        images, cams, pos, nrm, refs, vis, 11, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(anchor), np.asarray(ref_anchor))
    np.testing.assert_array_equal(np.asarray(aok), np.asarray(ref_aok))
    np.testing.assert_allclose(
        np.asarray(grid), np.asarray(ref_grid), atol=1e-5
    )


def test_paged_mixed_visibility(rng):
    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 16, mixed=True)
    ref_grid, _, ref_aok = allview_scores_xla(
        images, cams, pos, nrm, refs, vis, 11
    )
    grid, _, aok = allview_scores_triton(
        images, cams, pos, nrm, refs, vis, 11, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(aok), np.asarray(ref_aok))
    np.testing.assert_allclose(
        np.asarray(grid), np.asarray(ref_grid), atol=1e-5
    )
    # The no-visibility patch scores -1 everywhere.
    assert np.all(np.asarray(grid)[0] == -1.0)


def test_paged_texture16(rng):
    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 6)
    ref_grid, _, _ = allview_scores_xla(images, cams, pos, nrm, refs, vis, 16)
    grid, _, _ = allview_scores_triton(
        images, cams, pos, nrm, refs, vis, 16, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(grid), np.asarray(ref_grid), atol=1e-5
    )


def test_paged_off_frustum_sentinel(rng):
    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 3)
    pos = pos.at[1].set(jnp.asarray([50.0, 50.0, 0.0]))
    grid, _, aok = allview_scores_triton(
        images, cams, pos, nrm, refs, vis, 11, interpret=True
    )
    assert np.all(np.asarray(grid)[1] == -1.0)
    assert not np.asarray(aok)[1]


def test_paged_objective_matches_chunked(rng):
    """The all-views objective must equal the anchor-pinned-chunk
    objective (both XLA on CPU) for every simplex point."""
    import jax.numpy as jnp2

    from densepoints.pmvs.optimize import (
        photometric_objective,
        photometric_objective_allviews,
    )

    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 9, mixed=True)
    f_chunk = photometric_objective(
        images, cams, pos, nrm, refs, vis, 11, max_score_views=3
    )
    f_paged = photometric_objective_allviews(
        images, cams, pos, nrm, refs, vis, 11
    )
    params = jnp2.asarray(
        rng.uniform(-0.05, 0.05, (9, 4, 3)).astype(np.float32)
    )
    np.testing.assert_allclose(
        np.asarray(f_paged(params)),
        np.asarray(f_chunk(params)),
        rtol=1e-4,
        atol=5e-4,
    )


def _chunked_filter_reference(images, cams, state, texture_size, config):
    """The retired round-3 chunked filter, rebuilt from the parity pieces
    (_anchor_chunks + patch_ncc_scores) — an independent derivation of
    optimization.cpp:98-132 that the production paged path must match."""
    import dataclasses

    import jax.numpy as jnp2

    from densepoints.pmvs.optimize import _anchor_chunks, patch_ncc_scores

    B, V = state.vis.shape
    new_vis = jnp2.zeros((B, V), bool)
    n_scorable = jnp2.zeros((B,), jnp2.int32)
    for chunk_ids, chunk_ok in _anchor_chunks(
        state.vis, config.max_score_views
    ):
        scores, view_ids, ok = patch_ncc_scores(
            images, cams, state.position, state.normal, state.ref,
            state.vis, texture_size, config.max_score_views,
            view_ids=chunk_ids, ok=chunk_ok,
        )
        keep_slot = ok & (
            (jnp2.arange(ok.shape[1])[None, :] == 0)
            | (scores >= config.score_threshold)
        )
        flat_idx = (
            jnp2.arange(B, dtype=jnp2.int32)[:, None] * V + view_ids
        ).reshape(-1)
        new_vis = new_vis | (
            jnp2.zeros((B * V,), bool)
            .at[flat_idx]
            .max(keep_slot.reshape(-1))
        ).reshape(B, V)
        n_scorable = n_scorable + jnp2.sum(ok.at[:, 0].set(False), axis=1)
    n_after = jnp2.sum(new_vis, axis=1)
    alive = (
        state.alive
        & (n_scorable > 0)
        & (n_after >= config.min_visible_views)
    )
    return dataclasses.replace(state, vis=new_vis, alive=alive)


def test_paged_filter_matches_chunked(rng):
    from densepoints.config import OptimizeConfig
    from densepoints.pmvs.optimize import filter_by_error
    from densepoints.pmvs.patch import PatchState

    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 14, mixed=True)
    state = PatchState.create(
        np.asarray(pos), np.asarray(nrm), np.asarray(refs), np.asarray(vis)
    )
    out_chunk = _chunked_filter_reference(
        images, cams, state, 11, OptimizeConfig(max_score_views=3)
    )
    out_paged = filter_by_error(
        images, cams, state, 11, OptimizeConfig(sampling_impl="paged")
    )
    np.testing.assert_array_equal(
        np.asarray(out_paged.alive), np.asarray(out_chunk.alive)
    )
    np.testing.assert_array_equal(
        np.asarray(out_paged.vis), np.asarray(out_chunk.vis)
    )


@pytest.mark.parametrize("impl", ["xla", "triton"])
@pytest.mark.parametrize("k", [11, 16])
def test_scan_scale_scores_match_numpy_oracle(impl, k):
    """Both scoring paths against the float64 numpy oracle at scan scale.

    At 1600x1200 / focal 2900 reduced-precision geometry (bf16, or TF32
    on a GPU) moves texel coordinates by whole pixels and errs by > 1e-2;
    f32 geometry and sampling stay within 1e-3 of the oracle.
    """
    from tests.oracle import (
        allview_scores_numpy,
        compare_to_oracle,
        scan_scale_case,
    )

    cams, images, pos, nrm, refs, vis = scan_scale_case(
        np.random.default_rng(0)
    )
    want = allview_scores_numpy(cams, images, pos, nrm, refs, vis, k)
    args = (
        jnp.asarray(images), cams, jnp.asarray(pos), jnp.asarray(nrm),
        jnp.asarray(refs), jnp.asarray(vis),
    )
    if impl == "triton":
        got = allview_scores_triton(*args, k, interpret=True)[0]
    else:
        got = allview_scores_xla(*args, k)[0]
    st = compare_to_oracle(got, want, 1e-3)
    assert st["scored"] > 64, st
    assert st["max_abs"] <= 1e-3, st
    assert st["sentinels_match"], st
    assert st["accept_agreement"] == 1.0, st


def test_triton_pads_partial_programs(rng):
    """A batch that is not a multiple of the slots per program, with a
    payload count that ends mid-program, matches the reference."""
    scene, cams, images = _setup(rng)
    n = _slots_per_program(11) + 3
    pos, nrm, refs, vis = _patches(cams, rng, n, mixed=True)
    ref_grid, ref_anchor, ref_aok = allview_scores_xla(
        images, cams, pos, nrm, refs, vis, 11
    )
    plan = make_plan(vis)
    assert int(plan.count[0]) % _slots_per_program(11) != 0
    grid, anchor, aok = allview_scores_triton(
        images, cams, pos, nrm, refs, vis, 11, plan=plan, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(anchor), np.asarray(ref_anchor))
    np.testing.assert_array_equal(np.asarray(aok), np.asarray(ref_aok))
    np.testing.assert_allclose(
        np.asarray(grid), np.asarray(ref_grid), atol=1e-5
    )


def test_triton_empty_plan_scores_sentinel(rng):
    """No payload slots at all (every program exits at once): -1 grid."""
    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 8)
    vis = jnp.zeros_like(vis).at[:, 2].set(True)  # anchor only
    plan = make_plan(vis)
    assert int(plan.count[0]) == 0
    grid, anchor, aok = allview_scores_triton(
        images, cams, pos, nrm, refs, vis, 11, plan=plan, interpret=True
    )
    assert np.all(np.asarray(grid) == -1.0)
    assert np.all(np.asarray(anchor) == 2)
    _, _, ref_aok = allview_scores_xla(images, cams, pos, nrm, refs, vis, 11)
    np.testing.assert_array_equal(np.asarray(aok), np.asarray(ref_aok))


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_dispatch_lowers_per_platform(rng, platform):
    """`_allview_scores` lowers to the Triton kernel for CUDA and to the
    XLA reference elsewhere — chosen at lowering time, never at run time,
    and never in interpret mode on the GPU."""
    from densepoints.pmvs.optimize import _allview_scores

    scene, cams, images = _setup(rng)
    pos, nrm, refs, vis = _patches(cams, rng, 8)

    def f(im, p):
        return _allview_scores(im, cams, p, nrm, refs, vis, 11)[0]

    txt = (
        jax.jit(f).trace(images, pos)
        .lower(lowering_platforms=(platform,))
        .as_text()
    )
    has_kernel = "__gpu$xla.gpu.triton" in txt
    assert has_kernel == (platform == "cuda")
    if has_kernel:
        assert "allview_payload" in txt and "allview_anchor" in txt
