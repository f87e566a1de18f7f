"""Applications of the PyTorch port, ported from the repository's
``examples/``, each runnable as ``python -m webgpufft_tpu_torch.examples.<name>
[--device cpu]`` (on the card by default):

- ``spectral_filter``, ``image_blur_fftconv``, ``scipy_style``,
  ``signal_toolkit``, ``control_toolkit``: the plan and facade demos;
- ``aot_serving``: a plan exported in one process and served in another;
- ``mri_gridding``: radial MRI reconstruction on the NUFFT layer;
- ``system_identification``: training through the fftconv plan;
- ``navier_stokes2d``, ``navier_stokes3d``, ``poisson3d``, ``multichip_fft``:
  spectral solvers and transforms, on one device and over a mesh.
"""

__all__ = ["aot_serving", "control_toolkit", "image_blur_fftconv", "mri_gridding",
           "multichip_fft", "navier_stokes2d", "navier_stokes3d", "poisson3d",
           "scipy_style", "signal_toolkit", "spectral_filter", "system_identification"]
