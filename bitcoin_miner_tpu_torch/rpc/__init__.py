"""The gRPC hasher service: the ``Hasher`` seam across processes, so the
protocol side and the card can live in different processes or hosts
(``hasher_service``; imported only where a caller asks for it, since it
needs ``grpcio``)."""
