"""Command line entry point of the port, compatible with the reference's
``recon`` (configuration.cpp:109-123; see pipeline/config.py for the flags).

    python -m meshrecon_torch.cli SCENE.yaml [SCENE2.yaml ...] -o out.obj \\
        [--device cuda|cpu] [-e] [--ensemble-seeds 3,13] [-V] [-s 8] [-n 2]
    python -m meshrecon_torch.cli tracks/koule-tr.yaml --synthetic sphere

Each YAML's clip is decoded (``--synthetic`` renders fixture frames
instead); several YAMLs reconstruct one after another, or at once, a
thread each, with ``--scene-devices`` above 1.
"""

from __future__ import annotations

import sys


def main(argv=None, timer=None) -> int:
    """Run the reconstruction of every input YAML; ``timer`` (a StageTimer)
    collects the stage times when given."""
    from meshrecon_torch.pipeline.config import configs_from_args
    from meshrecon_torch.pipeline.reconstruct import (reconstruct,
                                                      reconstruct_scenes)
    from meshrecon_torch.utils.profiling import profile_trace

    configs = configs_from_args(argv)
    first = configs[0]
    first.log(2, " Loaded configuration and video clip")

    def run():
        if len(configs) == 1:
            reconstruct(first, timer=timer)
        else:
            reconstruct_scenes(configs, scene_devices=first.scene_devices,
                               timer=timer)

    if first.profile_dir:
        with profile_trace(first.profile_dir, first.device) as prof:
            run()
        print(f"profile: device busy {prof['device_busy_s']:.6f} s of "
              f"{prof['wall_s']:.6f} s profiled wall (share "
              f"{prof['busy_share']:.6f}; {prof['device_events']} kernels, "
              "copies and memsets)")
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
