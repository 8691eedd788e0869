"""The benchmark's general code: it knows no cell, configuration or metric by
name, and finds each in its own file (manifest.py)."""
