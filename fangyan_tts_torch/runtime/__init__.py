"""Serving runtimes: the HTTP and gRPC streaming servers and their clients,
the dataset runners and the disaggregated pipeline
(fangyan_tts_tpu/runtime). Importing a module here needs neither grpc nor
protobuf: the gRPC modules import them when they serve or call."""
