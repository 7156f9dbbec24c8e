"""The kubelet device plugin for ``nvidia.com/gpu``: port of
``tpu_operator/deviceplugin``.  Importing it imports neither ``grpc`` nor
``protobuf``: only serving and registering need the transport."""
