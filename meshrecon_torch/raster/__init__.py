"""Depth renders and projective texturing (port of meshrecon.raster)."""
