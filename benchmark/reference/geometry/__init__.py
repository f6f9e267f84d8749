"""Polygon geometry: primitives, the plain clip, host booleans."""
