"""Pyramids, warps and the variational flow (port of meshrecon.flow)."""
