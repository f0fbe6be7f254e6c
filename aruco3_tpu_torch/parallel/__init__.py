"""Multi-device entry points of the port over ``torch.distributed``: frame
batches split across ranks (``sharding``) and one frame split into row
bands (``spatial``)."""
