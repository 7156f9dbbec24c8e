"""Hand-written gRPC service handlers and stubs for the device-plugin API:
own copy of ``tpu_operator/deviceplugin/rpc.py``.

grpcio-tools (the _pb2_grpc generator) is not a dependency, so the service
handlers and stubs that `protoc-gen-grpc_python` would emit are written out
here — same method paths, same serializers.
"""

from __future__ import annotations

import grpc
import grpc.aio

from tpu_operator_torch.deviceplugin import api_pb2

REGISTRATION_SERVICE = "v1beta1.Registration"
DEVICE_PLUGIN_SERVICE = "v1beta1.DevicePlugin"
API_VERSION = "v1beta1"


# ---------------------------------------------------------------------------
# Server-side: generic handlers.


def registration_handler(servicer) -> grpc.GenericRpcHandler:
    """servicer: async Register(request, context) -> Empty"""
    return grpc.method_handlers_generic_handler(
        REGISTRATION_SERVICE,
        {
            "Register": grpc.unary_unary_rpc_method_handler(
                servicer.Register,
                request_deserializer=api_pb2.RegisterRequest.FromString,
                response_serializer=api_pb2.Empty.SerializeToString,
            )
        },
    )


def device_plugin_handler(servicer) -> grpc.GenericRpcHandler:
    """servicer implements the five DevicePlugin methods (async)."""
    return grpc.method_handlers_generic_handler(
        DEVICE_PLUGIN_SERVICE,
        {
            "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
                servicer.GetDevicePluginOptions,
                request_deserializer=api_pb2.Empty.FromString,
                response_serializer=api_pb2.DevicePluginOptions.SerializeToString,
            ),
            "ListAndWatch": grpc.unary_stream_rpc_method_handler(
                servicer.ListAndWatch,
                request_deserializer=api_pb2.Empty.FromString,
                response_serializer=api_pb2.ListAndWatchResponse.SerializeToString,
            ),
            "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
                servicer.GetPreferredAllocation,
                request_deserializer=api_pb2.PreferredAllocationRequest.FromString,
                response_serializer=api_pb2.PreferredAllocationResponse.SerializeToString,
            ),
            "Allocate": grpc.unary_unary_rpc_method_handler(
                servicer.Allocate,
                request_deserializer=api_pb2.AllocateRequest.FromString,
                response_serializer=api_pb2.AllocateResponse.SerializeToString,
            ),
            "PreStartContainer": grpc.unary_unary_rpc_method_handler(
                servicer.PreStartContainer,
                request_deserializer=api_pb2.PreStartContainerRequest.FromString,
                response_serializer=api_pb2.PreStartContainerResponse.SerializeToString,
            ),
        },
    )


# ---------------------------------------------------------------------------
# Client-side stubs.


class RegistrationStub:
    def __init__(self, channel: grpc.aio.Channel):
        self.Register = channel.unary_unary(
            f"/{REGISTRATION_SERVICE}/Register",
            request_serializer=api_pb2.RegisterRequest.SerializeToString,
            response_deserializer=api_pb2.Empty.FromString,
        )


class DevicePluginStub:
    def __init__(self, channel: grpc.aio.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/GetDevicePluginOptions",
            request_serializer=api_pb2.Empty.SerializeToString,
            response_deserializer=api_pb2.DevicePluginOptions.FromString,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{DEVICE_PLUGIN_SERVICE}/ListAndWatch",
            request_serializer=api_pb2.Empty.SerializeToString,
            response_deserializer=api_pb2.ListAndWatchResponse.FromString,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/GetPreferredAllocation",
            request_serializer=api_pb2.PreferredAllocationRequest.SerializeToString,
            response_deserializer=api_pb2.PreferredAllocationResponse.FromString,
        )
        self.Allocate = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/Allocate",
            request_serializer=api_pb2.AllocateRequest.SerializeToString,
            response_deserializer=api_pb2.AllocateResponse.FromString,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/PreStartContainer",
            request_serializer=api_pb2.PreStartContainerRequest.SerializeToString,
            response_deserializer=api_pb2.PreStartContainerResponse.FromString,
        )
