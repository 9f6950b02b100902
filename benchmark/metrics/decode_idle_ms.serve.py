"""The device's idle milliseconds a request while the host was in the
GPT decode loop: the idle gaps of the traced window whose midpoint lies
innermost in the program's span ``gpt.decode`` (the token loop after the
prefill), over the traced requests."""

from harness import spans


def read(ctx):
    return spans.idle_ms_per(ctx, "gpt.decode", "service.request")
