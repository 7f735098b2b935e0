from .io import (  # noqa: F401
    CSVIter, DataBatch, DataDesc, DataIter, ImageRecordIter, LibSVMIter,
    MNISTIter, NDArrayIter, ResizeIter,
)
