"""Small host-side utilities (plotting; the program's spans)."""
