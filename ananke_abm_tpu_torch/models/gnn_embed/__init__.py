"""GAT-ODE: graph-attention zone encoder + agent dynamics, integrate then
decode (port of ``ananke_abm_tpu.models.gnn_embed``)."""
