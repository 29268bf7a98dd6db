"""G1/G2 point arithmetic on digit planes."""
