"""The paper's examples as entry points of the port, each run as
``python -m repro_torch.examples.<name>``: ``allreduce_dlrm`` (data-
parallel DLRM training over the BALBOA allreduce), ``secure_flow`` (AES
and DPI on the RDMA datapath), ``dlrm_ingest`` (§8 streaming ingest
into DLRM training), ``serve`` (batched LM serving with the KV-cache
runtime) and ``quickstart`` (a small LM trained with the Trainer)."""
