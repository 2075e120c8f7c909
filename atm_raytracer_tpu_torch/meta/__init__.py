"""The metadata artifact (npz and reference bincode) and its viewer."""
