"""The loops that drive a window, one file each, found by the name in a
traffic file's "loop" key (kzgbench/generator.py)."""
