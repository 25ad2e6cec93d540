"""Small host-side utilities (plotting)."""
