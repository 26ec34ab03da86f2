from .nifti import NiftiImage, read_nifti, write_nifti
from .nz import NzModelFile, read_nz, write_nz
