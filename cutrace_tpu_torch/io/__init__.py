"""Host IO: image encoders (depth / normal / color maps)."""
