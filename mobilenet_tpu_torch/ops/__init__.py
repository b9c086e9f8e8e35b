"""Plain ops and the CUDA kernels' wrappers. Importing this package builds
nothing: each kernel is built on its first launch (`_build.library`)."""
