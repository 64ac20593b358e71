"""Surface meshing: alpha shapes (iteration 1), Poisson (later iterations),
component and support trimming, decimation, and the native helpers."""
