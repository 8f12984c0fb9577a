// Standalone KCP wire peer for differential interop testing.
//
// This is an INDEPENDENT second implementation of the KCP wire contract
// spoken by core/kcp.py (itself interop-class with the reference's
// kcp-go listener, ref: pkg/channeld/connection.go:207-216): 24-byte
// little-endian header (conv u32, cmd u8, frg u8, wnd u16, ts u32,
// sn u32, una u32, len u32), commands 81 PUSH / 82 ACK / 83 WASK /
// 84 WINS, cumulative `una` + selective ACK with ts echo, receive-window
// advertisement in `wnd`, MTU-1400 datagram packing, RTO with x1.5
// backoff, fast retransmit after 3 duplicate-ack spans.
//
// It deliberately shares no code or structure with the Python side: a
// C-style single-threaded poll loop with array-backed windows, so that
// any behavioral agreement between the two is evidence about the wire
// contract, not about shared bugs. (The ARQ itself lives in
// sdk/cpp/kcp_conv.h, shared with the C++ SDK's KCP transport — both
// are the same independent C++ lineage.)
//
// Modes:
//   kcp_peer echo <port>
//       Bind UDP <port>. First PUSH sn==0 from a new address opens the
//       conversation (server semantics); every delivered stream byte is
//       echoed back over the same conversation. Runs until killed.
//   kcp_peer send <host> <port> <nbytes> <seed>
//       Connect, stream <nbytes> of xorshift(seed) pattern, read the
//       echo, verify byte-for-byte. Exit 0 on success, 1 on mismatch or
//       timeout. Used with a lossy UDP proxy in between.
#include <arpa/inet.h>
#include <netinet/in.h>
#include <time.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <string>
#include <vector>

#include "../../sdk/cpp/kcp_conv.h"

namespace {

using namespace chtpu_kcp;


uint32_t xorshift(uint32_t& s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

int run_echo(int port) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(uint16_t(port));
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  fprintf(stdout, "READY\n");
  fflush(stdout);

  Conv conv;  // single-session echo peer
  bool open = false;
  uint8_t buf[65536];
  while (true) {
    pollfd pfd{fd, POLLIN, 0};
    poll(&pfd, 1, 10);
    if (pfd.revents & POLLIN) {
      sockaddr_in src{};
      socklen_t slen = sizeof(src);
      ssize_t n = recvfrom(fd, buf, sizeof(buf), 0,
                           reinterpret_cast<sockaddr*>(&src), &slen);
      if (n >= kHeader) {
        if (!open) {
          // Server-open semantics: first PUSH with sn==0 creates it.
          if (buf[4] == kPush && get32(buf + 12) == 0) {
            conv.conv = get32(buf);
            conv.fd = fd;
            conv.peer = src;
            conv.have_peer = true;
            open = true;
          }
        }
        if (open && conv.input(buf, size_t(n)) && !conv.stream_in.empty()) {
          conv.queue_stream(conv.stream_in.data(), conv.stream_in.size());
          conv.stream_in.clear();
        }
      }
    }
    if (open) {
      conv.flush();
      if (conv.dead) return 2;
    }
  }
}

int run_send(const char* host, int port, size_t nbytes, uint32_t seed) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  inet_pton(AF_INET, host, &addr.sin_addr);
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("connect");
    return 1;
  }
  Conv conv;
  conv.conv = (seed | 1);
  conv.fd = fd;

  std::vector<uint8_t> pattern(nbytes);
  uint32_t s = seed ? seed : 0xdecafbad;
  for (size_t i = 0; i < nbytes; i++) pattern[i] = uint8_t(xorshift(s) >> 24);
  conv.queue_stream(pattern.data(), nbytes);

  size_t verified = 0;
  double deadline = mono_now() + 60.0;
  uint8_t buf[65536];
  while (verified < nbytes) {
    if (mono_now() > deadline) {
      fprintf(stderr, "TIMEOUT verified=%zu/%zu\n", verified, nbytes);
      return 1;
    }
    conv.flush();
    if (conv.dead) {
      fprintf(stderr, "DEAD LINK\n");
      return 2;
    }
    pollfd pfd{fd, POLLIN, 0};
    poll(&pfd, 1, 10);
    if (pfd.revents & POLLIN) {
      ssize_t n = recv(fd, buf, sizeof(buf), 0);
      if (n >= kHeader) conv.input(buf, size_t(n));
    }
    if (!conv.stream_in.empty()) {
      for (uint8_t b : conv.stream_in) {
        if (verified >= nbytes) {
          fprintf(stderr, "OVERDELIVERY past %zu bytes\n", nbytes);
          return 1;
        }
        if (b != pattern[verified]) {
          fprintf(stderr, "MISMATCH at %zu: got %02x want %02x\n", verified,
                  b, pattern[verified]);
          return 1;
        }
        verified++;
      }
      conv.stream_in.clear();
    }
  }
  fprintf(stdout, "OK %zu\n", verified);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc >= 3 && strcmp(argv[1], "echo") == 0)
    return run_echo(atoi(argv[2]));
  if (argc >= 6 && strcmp(argv[1], "send") == 0)
    return run_send(argv[2], atoi(argv[3]), strtoul(argv[4], nullptr, 10),
                    uint32_t(strtoul(argv[5], nullptr, 10)));
  fprintf(stderr,
          "usage: kcp_peer echo <port> | kcp_peer send <host> <port> "
          "<nbytes> <seed>\n");
  return 64;
}
