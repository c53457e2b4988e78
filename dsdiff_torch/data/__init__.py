"""Host-side data: slice stores, transforms, loaders, NIfTI volumes."""
