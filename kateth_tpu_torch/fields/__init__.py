"""Field arithmetic on 16-bit digit planes: Fr, Fp and the Fp2/Fp6/Fp12
tower."""
