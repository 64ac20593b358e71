"""The fused dense update (port of meshrecon.pipeline.fused)."""
