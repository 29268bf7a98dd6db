"""The entries a traffic file can drive, one file each, found by the name
in its "entry" key (kzgbench/generator.py)."""
