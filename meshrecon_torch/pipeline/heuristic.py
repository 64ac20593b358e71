"""Strategy layer: iteration control, camera-pair selection, tessellation
dispatch, point-filter policy — the Heuristic class of the reference
(heuristic.cpp). Port of meshrecon/pipeline/heuristic.py: host numpy policy
code, with the occlusion probe (``Renderer.depth_at``) and the Poisson
solve on the configuration's device.

The reference's chooseCameras renders a FULL depth frame from each of 200
random surface viewpoints and reads back a handful of pixels per render
(heuristic.cpp:448-459). Here all 200 shots and all scene cameras become one
batched `depth_probe` call (S x C ray tests against the triangle soup); the
remaining weighted-sampling logic is scalar host code driven by a seeded RNG
(the reference uses unseeded cv::randu, so outputs are only statistically
comparable; a fixed seed makes our runs reproducible).

Known deliberate divergence: the reference samples the occlusion depth map at
``row = (y+1) h/2`` (heuristic.cpp:307-308) although its depth frames are
vertically flipped to row0=top (render_glx.cpp:392) — a vertical-mirror bug.
We sample at the geometrically consistent position.
"""

from __future__ import annotations

import numpy as np

from meshrecon_torch.geometry.camera import np_extract_camera_center
from meshrecon_torch.io.obj import Mesh, read_mesh
from meshrecon_torch.meshing.alpha import alpha_shape_faces
from meshrecon_torch.meshing.components import (keep_supported_components,
                                                trim_unsupported_faces)
from meshrecon_torch.meshing.extras import normalize_normals_average
from meshrecon_torch.meshing.poisson import poisson_surface, robust_grid_frame

FOCAL = 0.5  # focal length of face-viewer cameras (heuristic.cpp:9)
FACE_NEAR = 0.001  # heuristic.cpp:239
FACE_FAR = 10.0  # heuristic.cpp:454
SHOT_COUNT = 200  # heuristic.cpp:447


def face_camera(vertices4, face, u1, u2, far=FACE_FAR, focal=FOCAL):
    """Viewer camera on a random point of a face, looking along its normal.

    Mirrors faceCamera (heuristic.cpp:193-247): rotation aligned with the
    face normal (or axis flip when the normal is vertical), center at the
    barycentric point (u1, u2), projection with near=0.001 and the given far.
    """
    a, b, c = (
        vertices4[face[0], :3] / vertices4[face[0], 3],
        vertices4[face[1], :3] / vertices4[face[1], 3],
        vertices4[face[2], :3] / vertices4[face[2], 3],
    )
    normal = np.cross(b - a, c - b)
    nl = np.linalg.norm(normal)
    if nl < 1e-20:
        normal = np.array([0.0, 0.0, 1.0])
    else:
        normal = normal / nl
    if u1 + u2 > 1:
        u1, u2 = 1 - u1, 1 - u2
    ce = a * u1 + b * u2 + c * (1 - u1 - u2)

    x, y, z = normal
    xys = x * x + y * y
    xy = np.sqrt(xys)
    if xy > 0:
        rt = np.array(
            [
                [z * x / xy, z * y / xy, xy, -z * (ce[0] * x + ce[1] * y) / xy
                 - ce[2] * xy],
                [-y / xy, x / xy, 0, (ce[0] * y - ce[1] * x) / xy],
                [-x, -y, z, ce[0] * x + ce[1] * y - ce[2] * z],
                [0, 0, 0, 1],
            ],
            dtype=np.float64,
        )
    else:
        s = 1.0 if z > 0 else -1.0
        rt = np.array(
            [
                [1, 0, 0, -ce[0]],
                [0, s, 0, -ce[1]],
                [0, 0, s, -ce[2]],
                [0, 0, 0, 1],
            ],
            dtype=np.float64,
        )
    near = FACE_NEAR
    k = np.array(
        [
            [focal, 0, 0, 0],
            [0, focal, 0, 0],
            [0, 0, (near + far) / (far - near), 2 * near * far / (near - far)],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    return (k @ rt).astype(np.float32)


def face_areas(mesh: Mesh) -> np.ndarray:
    soup = mesh.triangle_soup
    e = soup[:, 1] - soup[:, 0]
    f = soup[:, 2] - soup[:, 1]
    return 0.5 * np.linalg.norm(np.cross(e, f), axis=1)


class Heuristic:
    """Iteration policy + camera selection + tessellation dispatch."""

    def __init__(self, config):
        self.config = config
        self.iteration = 0
        self.alpha_vals: list[float] = []
        self.chosen: list[tuple[int, list[int]]] = []
        self.rng = np.random.default_rng(config.seed)

    # -- iteration control (heuristic.cpp:31-35) --
    def not_happy(self, points) -> bool:
        self.iteration += 1
        return self.iteration <= self.config.iteration_count

    # -- tessellation dispatch (heuristic.cpp:525-545) --
    def tessellate(self, points: np.ndarray, normals: np.ndarray,
                   final: bool = False) -> Mesh:
        if self.iteration <= 1:
            if self.config.in_mesh_file:
                self.alpha_vals.append(1.0)
                return read_mesh(self.config.in_mesh_file)
            faces, alpha = alpha_shape_faces(points)
            self.alpha_vals.append(alpha)
            return Mesh(points, faces)
        rounds = int(self.config.consensus_rounds)
        if final and rounds > 0 and len(points) > 1000:
            # ITERATED-CONSENSUS trim of the input cloud before the final
            # mesh (round-4 attribution finding): the worst-seed median
            # lives in a ~15% minority of high-confidence, cross-supported
            # GARBAGE points spread across bundles — invisible to every
            # static per-point signal (confidence, cross-bundle support),
            # but far from the Poisson surface of the good majority. Mesh,
            # drop points > tau * median-NN-distance from the surface,
            # re-mesh — with RE-ADMISSION each round (the keep set is
            # re-derived from the full cloud, so points wrongly dropped
            # while the surface was still dragged come back). Measured at
            # 1/8-res koule seed 5: med 0.0345 -> 0.0107 r in 3 rounds
            # (oracle ceiling 0.0094); seed 3 unharmed. Cost: ``rounds``
            # extra host-side Poisson meshes; no extra device compute
            # (compare: the 2-draw ensemble costs a full second refinement).
            from scipy.spatial import cKDTree

            tau = float(self.config.consensus_tau)
            p3 = np.asarray(points, np.float64)
            if p3.shape[1] == 4:
                p3 = p3[:, :3] / p3[:, 3:4]
            dnn, _ = cKDTree(p3).query(p3, k=2)
            nn_med = float(np.median(dnn[:, 1])) or 1e-9
            keep = np.ones(len(points), bool)
            for _ in range(rounds):
                mesh = self._poisson_mesh(points[keep], normals[keep],
                                          points[keep])
                if not len(mesh.faces):
                    break
                v3 = np.asarray(mesh.vertices, np.float64)
                if v3.shape[1] == 4:
                    v3 = v3[:, :3] / v3[:, 3:4]
                dm, _ = cKDTree(v3).query(p3, k=1)
                new_keep = dm <= tau * nn_med
                if new_keep.sum() < 1000 or bool(np.all(new_keep == keep)):
                    keep = new_keep if new_keep.sum() >= 1000 else keep
                    break
                keep = new_keep
            mesh = self._poisson_mesh(points[keep], normals[keep],
                                      points[keep])
            self.alpha_vals.append(self.alpha_vals[-1] / 2.0)
            return mesh
        mesh = self._poisson_mesh(points, normals, points)
        self.alpha_vals.append(self.alpha_vals[-1] / 2.0)
        return mesh

    def _poisson_mesh(self, points: np.ndarray, normals: np.ndarray,
                      support: np.ndarray) -> Mesh:
        """Poisson surface + supported-components + support-distance trim
        (the iteration>=2 meshing body; ``support`` is the cloud faces must
        stay near for the trim/component tests)."""
        # normal magnitude is per-point confidence; normalize the global
        # scale (unit AVERAGE length, like pcl.cpp:39-44) so accumulated
        # batches from different camera bundles weight comparably and the
        # f32 splat cannot overflow
        sp, sn = points, normals
        prune = self.config.confidence_prune
        if prune > 0.0 and len(points) > 1000:
            # splat only the top-(1-q) confidence points into the Poisson
            # indicator (the points themselves stay in the pipeline): the
            # soft magnitude weighting alone lets a heavy low-confidence
            # tail roughen the surface
            conf = np.linalg.norm(np.asarray(normals, np.float64), axis=1)
            keep = conf >= np.quantile(conf, prune)
            sp, sn = points[keep], normals[keep]
        mesh = poisson_surface(sp, normalize_normals_average(sn),
                               grid=self.config.poisson_grid,
                               sigma=self.config.poisson_sigma,
                               device=self.config.device)
        # drop spurious detached sheets (CGAL's seeded mesher never grows
        # them; our FFT indicator can — see meshing/components.py)
        mesh = keep_supported_components(mesh, support)
        trim = self.config.poisson_trim
        if trim > 0.0 and len(mesh.faces):
            # cell size from the SPLAT set sp (the frame poisson_surface
            # actually used — with --confidence-prune the full cloud's
            # outliers would widen the span and mis-scale "grid cells");
            # support distance against the FULL support cloud (every
            # observation supports the surface, pruned or not)
            sp3 = np.asarray(sp, np.float64)
            if sp3.shape[1] == 4:
                sp3 = sp3[:, :3] / sp3[:, 3:4]
            pts3 = np.asarray(support, np.float64)
            if pts3.shape[1] == 4:
                pts3 = pts3[:, :3] / pts3[:, 3:4]
            _, scale = robust_grid_frame(sp3, self.config.poisson_grid)
            mesh = trim_unsupported_faces(mesh, pts3, trim / scale)
        return mesh

    def filter_radius_sq(self) -> float:
        return self.alpha_vals[-1] / 4.0  # heuristic.cpp:63

    # -- camera selection (heuristic.cpp:429-486) --
    def choose_cameras(self, mesh: Mesh, cameras: np.ndarray, renderer) -> int:
        cfg = self.config
        areas = face_areas(mesh)
        total_area = float(areas.sum())
        if total_area <= 0 or len(areas) == 0:
            self.chosen = []
            return 0
        cum = np.concatenate([[0.0], np.cumsum(areas)])

        n_cams = len(cameras)
        sampling_resolution = (
            np.sqrt(n_cams) * cfg.width * cfg.height
            / (total_area * cfg.camera_threshold)
        )

        # face-viewer far plane from the scene geometry. The reference
        # hardcodes far=10 with the comment "fixme, may fail. Should be
        # calculated from the scene geometry" (heuristic.cpp:454) — and it
        # does fail on koberec-scale scenes whose cameras sit 10+ units out
        # (their centers land beyond the frustum and every visibility test
        # rejects). We compute it as the author intended.
        verts3 = mesh.vertices[:, :3] / mesh.vertices[:, 3:4]
        centroid = verts3.mean(axis=0)
        bbox_r = float(np.linalg.norm(verts3 - centroid, axis=1).max())
        centers_pre = np.stack([np_extract_camera_center(c) for c in cameras])
        centers3_pre = centers_pre[:, :3] / centers_pre[:, 3:4]
        cam_r = float(np.linalg.norm(centers3_pre - centroid, axis=1).max())
        face_far = max(FACE_FAR, 2.0 * (bbox_r + cam_r))

        # --- batched geometry for all shots ---
        shots = SHOT_COUNT
        choice = self.rng.random(shots) * total_area
        face_idx = np.clip(np.searchsorted(cum, choice, side="right") - 1,
                           0, len(areas) - 1)
        u1 = self.rng.random(shots)
        u2 = self.rng.random(shots)
        viewers = np.stack(
            [
                face_camera(mesh.vertices, mesh.faces[face_idx[s]], u1[s],
                            u2[s], far=face_far)
                for s in range(shots)
            ]
        )

        centers = centers_pre
        centers3 = centers3_pre

        # camera centers projected from every viewer: (S, C, 4)
        cfv = np.einsum("sij,cj->sci", viewers.astype(np.float64), centers)
        cfv_w = cfv[..., 3]
        cfv_w = np.where(np.abs(cfv_w) < 1e-20, 1e-20, cfv_w)
        cfv_n = cfv[..., :3] / cfv_w[..., None]

        # occlusion probe: depth along each (viewer, camera) ray, one call
        sample_xy = cfv_n[..., :2].astype(np.float32)
        probe = renderer.depth_at(viewers, sample_xy).cpu().numpy()  # (S, C)

        # viewer centers projected into every camera: (S, C, 4)
        vcenters = np.stack([np_extract_camera_center(v) for v in viewers])
        vfc = np.einsum("cij,sj->sci", cameras.astype(np.float64), vcenters)
        dist = vfc[..., 3] / vcenters[:, None, 3]
        vfc_w = np.where(np.abs(vfc[..., 3]) < 1e-20, 1e-20, vfc[..., 3])
        vfc_n = vfc[..., :3] / vfc_w[..., None]

        # the four visibility tests of filterCameras (heuristic.cpp:285-341)
        ok = (np.abs(cfv_n[..., 2]) <= 1.0)
        inb = (np.abs(sample_xy[..., 0]) <= 1.0) & (np.abs(sample_xy[..., 1]) <= 1.0)
        occluded = inb & (probe != 1.0) & (probe <= cfv_n[..., 2])
        ok &= inb & ~occluded
        ok &= dist > 0
        ok &= (np.abs(vfc_n[..., 0]) <= 1.0) & (np.abs(vfc_n[..., 1]) <= 1.0)

        cos_v = np.sqrt(
            1.0 / (1.0 + (cfv_n[..., 0] ** 2 + cfv_n[..., 1] ** 2) / FOCAL**2)
        )

        # --- sequential weighted selection (tiny host loop) ---
        chosen: list[tuple[int, list[int]]] = []
        weights: dict[tuple[int, int], float] = {}
        camera_count = 0
        boost_main = cfg.camera_threshold
        boost_side = cfg.camera_threshold / 10.0
        for s in range(shots):
            idxs = np.where(ok[s])[0]
            if len(idxs) < 2:
                continue
            cos_s = cos_v[s, idxs]
            d_s = dist[s, idxs]
            vx, vy = cfv_n[s, idxs, 0], cfv_n[s, idxs, 1]

            # chooseMain (heuristic.cpp:345-369)
            w_main = cos_s / np.maximum(d_s * d_s, 1e-20)
            main_weight_sum = float(w_main.sum())
            boosted = w_main.copy()
            for t, ci in enumerate(idxs):
                if (ci, ci) in weights:
                    boosted[t] += w_main[t] * boost_main * len(idxs)
            r = self.rng.random() * boosted.sum()
            mi = int(np.searchsorted(np.cumsum(boosted), r))
            mi = min(mi, len(idxs) - 1)
            main = int(idxs[mi])

            # chooseSide (heuristic.cpp:372-426)
            sel = idxs != main
            if not np.any(sel):
                continue
            parallax2 = ((vx[sel] - vx[mi]) ** 2 + (vy[sel] - vy[mi]) ** 2) / FOCAL
            w_side = cos_s[sel] * parallax2 / np.maximum(d_s[sel] ** 2, 1e-20)
            actual_sum = float(w_side.sum())
            if actual_sum <= 0:
                continue
            side_ids = idxs[sel]
            boosted = w_side.copy()
            for t, ci in enumerate(side_ids):
                key = (main, int(ci))
                if weights.get(key, 0.0) >= 1.0:
                    boosted[t] += w_side[t] * boost_side * len(idxs)
            r = self.rng.random() * boosted.sum()
            si = int(np.searchsorted(np.cumsum(boosted), r))
            si = min(si, len(side_ids) - 1)
            side = int(side_ids[si])
            key = (main, side)
            if weights.get(key, 0.0) >= 1.0:
                continue  # already picked earlier (heuristic.cpp:405-409)
            weights[(main, main)] = 1.0
            threshold = shots * main_weight_sum / max(sampling_resolution, 1e-20)
            add = w_side[si] / max(threshold * actual_sum, 1e-20)
            weights[key] = weights.get(key, 0.0) + add
            if weights[key] >= 1.0:
                camera_count += 1
                pos = next((p for p, (m, _) in enumerate(chosen) if m == main), -1)
                if pos < 0:
                    chosen.append((main, [side]))
                elif side not in chosen[pos][1]:
                    chosen[pos][1].append(side)

        chosen = self._enforce_coverage(chosen, ok, cos_v, dist, cfv_n)
        chosen = self._enforce_min_bundles(chosen, weights, ok, cos_v, dist,
                                           cfv_n)
        cap = int(self.config.max_sides)
        if cap > 0:
            # keep the FIRST cap sides (threshold-crossing order — the
            # strongest accumulators cross first); pins the flow-stack K
            # bucket set to {4, 8} so camera re-draws cannot introduce new
            # compiled shapes (see reconstruct._k_bucket)
            chosen = [(m, s[:cap]) for m, s in chosen]
        chosen.sort()
        self.chosen = chosen
        return max(camera_count, len(chosen))

    @staticmethod
    def _best_side(main, ok, cos_v, dist, cfv_n, shot_mask=None):
        """Best side camera for ``main`` over the masked shots by summed
        reference side weight cos*parallax^2/d^2; (side, score) or (-1, 0)."""
        vx, vy = cfv_n[..., 0], cfv_n[..., 1]
        m_vis = ok[:, main] if shot_mask is None else shot_mask & ok[:, main]
        if not np.any(m_vis):
            return -1, 0.0
        par2 = ((vx[m_vis] - vx[m_vis, main][:, None]) ** 2
                + (vy[m_vis] - vy[m_vis, main][:, None]) ** 2) / FOCAL
        w = np.where(ok[m_vis], cos_v[m_vis] * par2
                     / np.maximum(dist[m_vis], 1e-20) ** 2, 0.0)
        w[:, main] = 0.0
        score = w.sum(axis=0)
        side = int(score.argmax())
        return (side, float(score[side])) if score[side] > 0 else (-1, 0.0)

    def _enforce_min_bundles(self, chosen, weights, ok=None, cos_v=None,
                             dist=None, cfv_n=None):
        """Bundle-count floor (``min_bundles``): a bad draw can stop the
        accumulate-to-threshold loop at 2-4 bundles (measured at 1/8 res,
        NOTES_ROUND4.md) and per-run quality tracks that count. Promote the
        highest-accumulated sub-threshold (main, side) pairs — the policy's
        own ranking of "nearly chosen" — one pair per new main, until the
        floor is met or candidates run out. Reference analog: none; its
        unseeded draw (heuristic.cpp:429-486) simply gets unlucky."""
        floor = int(self.config.min_bundles)
        if floor <= 0 or len(chosen) >= floor:
            return chosen
        mains_have = {m for m, _ in chosen}
        best: dict[int, tuple[float, int]] = {}  # main -> (weight, side)
        for (m, s), w in weights.items():
            if m == s or m in mains_have or w >= 1.0:
                continue
            if w > best.get(m, (0.0, -1))[0]:
                best[m] = (w, s)
        promoted = 0
        for m, (w, s) in sorted(best.items(), key=lambda kv: -kv[1][0]):
            if len(chosen) >= floor:
                break
            chosen.append((m, [s]))
            promoted += 1
        # weight table exhausted (sparse draws sample few distinct mains):
        # synthesize bundles from the visibility matrix — rank unchosen
        # cameras by summed main view weight, pair each with its best side
        synthesized = 0
        if len(chosen) < floor and ok is not None and ok.size:
            w_main = np.where(ok, cos_v / np.maximum(dist, 1e-20) ** 2, 0.0)
            rank = np.argsort(-w_main.sum(axis=0))
            have = {m for m, _ in chosen}
            for m in rank:
                if len(chosen) >= floor:
                    break
                m = int(m)
                if m in have or w_main[:, m].sum() <= 0:
                    continue
                side, score = self._best_side(m, ok, cos_v, dist, cfv_n)
                if side < 0:
                    continue
                chosen.append((m, [side]))
                have.add(m)
                synthesized += 1
        if (promoted or synthesized) and \
                self.config.verbosity >= 1:
            print(f"Bundle floor: +{promoted} promoted, +{synthesized} "
                  f"synthesized mains ({len(chosen)}/{floor})", flush=True)
        return chosen

    def _enforce_coverage(self, chosen, ok, cos_v, dist, cfv_n):
        """Deterministic repair pass over the stochastic selection.

        The reference's accumulate-to-threshold policy (heuristic.cpp:
        429-486, unseeded cv::randu upstream) leaves per-run quality at the
        mercy of the draw: a bad seed leaves surface regions with no main
        camera at all, or mains whose only sides have near-zero parallax
        (measured med-err spread 0.125/0.173/0.219 r over seeds at an
        identical koule config). Two repairs, both reusing the 200 shots'
        visibility matrix (no extra renders):

        1. COVERAGE (``camera_coverage`` fraction): greedy set cover — while
           fewer than that fraction of the surface shots are WELL seen by a
           chosen main, add the camera well-seeing the most uncovered shots
           (with its best side by the reference's own cos*parallax^2/d^2
           weight). "Well seen" means the main's cos/d^2 view weight is
           within ``coverage_quality`` of the best possible main for that
           shot — mere visibility is too weak a metric: on koule's 31-camera
           arc ONE camera sees every servable shot, so a visibility-based
           repair never fires (round-3 full-res study, NOTES_ROUND4.md).
        2. BASELINE DIVERSITY (``baseline_diversity``): for each chosen
           main, if the best side NOT in its bundle outscores the best
           side IN it by more than a factor of ``baseline_diversity``,
           append the better side — a main whose sides all have narrow
           baselines triangulates at high depth variance no matter how
           good the flow.
        """
        cfg = self.config
        frac = float(cfg.camera_coverage)
        div = float(cfg.baseline_diversity)
        if (frac <= 0.0 and div <= 0.0) or ok.size == 0:
            return chosen

        shots, n_cams = ok.shape
        w_main = np.where(ok, cos_v / np.maximum(dist, 1e-20) ** 2, 0.0)
        # per-(shot, main, side) weight collapses to per-(shot, side) once
        # the main is fixed; precompute the shot-visibility weights
        vx, vy = cfv_n[..., 0], cfv_n[..., 1]
        added = {"coverage": 0, "diversity": 0}  # repair-fire telemetry

        def best_side(main, shot_mask):
            return self._best_side(main, ok, cos_v, dist, cfv_n, shot_mask)

        cap = int(cfg.max_sides)
        displaced = [0]  # sides evicted to make room for a repair side

        def append_pair(main, side, tag):
            pos = next((p for p, (m, _) in enumerate(chosen) if m == main), -1)
            if pos < 0:
                chosen.append((main, [side]))
                added[tag] += 1
            elif side not in chosen[pos][1]:
                sides_ = chosen[pos][1]
                if cap > 0 and len(sides_) >= cap:
                    # the bundle is already at the K cap: REPLACE the
                    # weakest side (last in threshold-crossing order)
                    # instead of appending — the caller's post-repair
                    # truncation would otherwise silently drop the
                    # parallax-critical repair side (round-4 advisor).
                    sides_[-1] = side
                    displaced[0] += 1
                else:
                    sides_.append(side)
                added[tag] += 1

        cov0 = cov1 = serv = -1
        if frac > 0.0:
            all_shots = np.ones(shots, bool)
            q = float(cfg.coverage_quality)
            w_best = np.maximum(w_main.max(axis=1), 1e-30)
            well = ok & (w_main >= q * w_best[:, None])
            covered = np.zeros(shots, bool)
            for m, _sides in chosen:
                covered |= well[:, m]
            # shots no camera pair can serve don't count against coverage
            servable = ok.sum(axis=1) >= 2
            serv = int(servable.sum())
            cov0 = int((covered & servable).sum())
            target = frac * max(serv, 1)
            banned = np.zeros(n_cams, bool)  # mains with no usable side
            while int((covered & servable).sum()) < target:
                gain = (well & (~covered & servable)[:, None]).sum(axis=0)
                for m, _sides in chosen:
                    gain[m] = 0  # already chosen mains add no coverage
                gain[banned] = 0
                main = int(gain.argmax())
                if gain[main] <= 0:
                    break
                side, score = best_side(main, all_shots)
                if side < 0:
                    # no usable side: BAN this main (marking its shots
                    # covered would block a different main from serving
                    # them and silently void the coverage guarantee)
                    banned[main] = True
                    continue
                append_pair(main, side, "coverage")
                covered |= well[:, main]
            cov1 = int((covered & servable).sum())

        if div > 0.0:
            for main, sides in list(chosen):
                m_shots = ok[:, main]
                cand, cand_score = best_side(main, np.ones(shots, bool))
                if cand < 0 or cand in sides:
                    continue
                par2_have = 0.0
                for s_ in sides:
                    vis = m_shots & ok[:, s_]
                    if np.any(vis):
                        p2 = ((vx[vis, s_] - vx[vis, main]) ** 2
                              + (vy[vis, s_] - vy[vis, main]) ** 2) / FOCAL
                        w = (cos_v[vis, s_] * p2
                             / np.maximum(dist[vis, s_], 1e-20) ** 2)
                        par2_have = max(par2_have, float(w.sum()))
                if par2_have * div < cand_score:
                    append_pair(main, cand, "diversity")
        if cfg.verbosity >= 1:
            print(f"Coverage repair: +{added['coverage']} coverage, "
                  f"+{added['diversity']} diversity pairs "
                  f"({len(chosen)} mains; covered {cov0}->{cov1}"
                  f" of {serv} servable shots"
                  + (f"; {displaced[0]} weakest sides displaced at the "
                     f"K cap" if displaced[0] else "") + ")", flush=True)
        return chosen

    def camera_bundles(self):
        """[(main_frame, [side_frames...])], the begin/nextMain/Side iterator
        surface of the reference (heuristic.cpp:489-522) as plain data."""
        return list(self.chosen)
