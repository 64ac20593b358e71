"""The flow update, plain: what the program's fused flow update computes
for B main cameras with K (padded) sides each, composed of the reference's
layers in the program's order (renders, projective texturing and the mix
chain, one batched flow solve, the first-order re-warp's pyramid-L1
variance, Gauss-Newton triangulation, normals)."""

from __future__ import annotations

import torch

from benchmark.reference.flow import compare, variational_flow
from benchmark.reference.fragment import mix_chain, projected_image
from benchmark.reference.normals import estimate_normals_batched
from benchmark.reference.precision import Arith
from benchmark.reference.raster import render_depth
from benchmark.reference.triangulate import triangulate


def flow_update(inputs, height: int, width: int, options: dict,
                precision: str = "float32") -> dict:
    """inputs: the update's ten inputs (soup, soup_valid, cam_mains,
    frames_main, side_cams, side_frames, side_valid, centers,
    centers_valid, n_side); options: levels, warps, fine_warps, iters,
    alpha, rho, sampling. Returns dict(point4, normals, pdf, valid, depth,
    gn_sweeps)."""
    (soup, soup_valid, cam_mains, frames_main, side_cams, side_frames,
     side_valid, centers, centers_valid, n_side) = inputs
    arith = Arith(precision)
    with arith.backend(), torch.no_grad():
        frames_main = frames_main.to(torch.float32)
        side_cams = side_cams.to(torch.float32)
        side_frames = side_frames.to(torch.float32)
        cam_mains = cam_mains.to(torch.float32)
        side_valid = side_valid.to(torch.bool)
        b, k = side_frames.shape[:2]
        all_cams = torch.cat([cam_mains[:, None], side_cams], dim=1)
        all_depths = render_depth(all_cams.reshape(b * (k + 1), 4, 4), soup,
                                  soup_valid, height, width).reshape(
                                      b, k + 1, height, width)
        depth0 = all_depths[:, 0]
        intens, masks = projected_image(arith, cam_mains, depth0,
                                        side_frames, side_cams,
                                        all_depths[:, 1:])
        mixed_all, depth_final = mix_chain(intens, masks, frames_main,
                                           depth0, side_valid)
        flows2, rewarped = variational_flow(
            frames_main[:, None], mixed_all, levels=options["levels"],
            iters=options["iters"], warps=options["warps"],
            alpha=options["alpha"], rho=options["rho"],
            fine_warps=options["fine_warps"])
        var = compare(frames_main[:, None], rewarped)
        out = triangulate(arith, flows2[..., 0], flows2[..., 1], var,
                          cam_mains, side_cams, side_valid, depth_final,
                          sampling=options["sampling"])
        normals = estimate_normals_batched(out["point4"], out["valid"],
                                           out["pdf"], centers,
                                           centers_valid, n_side)
    return {"point4": out["point4"], "normals": normals, "pdf": out["pdf"],
            "valid": out["valid"], "depth": depth_final,
            "gn_sweeps": out["gn_sweeps"]}
