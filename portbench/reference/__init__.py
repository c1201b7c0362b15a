"""Plain NumPy references that decide `correct`; they import nothing of this repository."""
