"""Host-side analysis hooks of the port (the SyncHook seam)."""
