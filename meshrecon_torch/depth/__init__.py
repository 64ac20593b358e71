"""Triangulation and normals (port of meshrecon.depth)."""
