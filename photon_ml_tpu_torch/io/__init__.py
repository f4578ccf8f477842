"""Host-side I/O: Avro codec, schemas, feature index maps, GAME ingestion,
model and score files (port of ``photon_ml_tpu/io``)."""
