"""KV-cache containers: capacity slabs with the FIER side-car."""
