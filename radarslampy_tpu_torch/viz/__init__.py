"""Host-side figures of a run (numpy and matplotlib; never the device)."""
