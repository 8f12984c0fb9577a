// Native wire codec for channeld-tpu.
//
// The per-packet hot path — 5-byte tag framing plus snappy compression
// (wire spec: ref pkg/channeld/connection.go:445-541, :683-697) — as a
// CPython extension. The gateway handles every inbound/outbound byte
// through this codec; the Python implementation in protocol/framing.py
// stays as the semantic reference and fallback.
//
// Linked against the system libsnappy via its stable C ABI (snappy-c.h);
// prototypes are declared here because the image ships the library
// without headers.
//
// Build: scripts/build_native.sh  ->  channeld_tpu/native/_codec.*.so

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

extern "C" {
// snappy-c.h stable ABI (status: 0 = OK, 1 = INVALID_INPUT, 2 = BUFFER_TOO_SMALL)
int snappy_compress(const char* input, size_t input_length, char* compressed,
                    size_t* compressed_length);
int snappy_uncompress(const char* compressed, size_t compressed_length,
                      char* uncompressed, size_t* uncompressed_length);
size_t snappy_max_compressed_length(size_t source_length);
int snappy_uncompressed_length(const char* compressed, size_t compressed_length,
                               size_t* result);
}

static const unsigned char MAGIC0 = 0x43;  // 'C'
static const unsigned char MAGIC1 = 0x48;  // 'H'
static const size_t HEADER_SIZE = 5;
static const size_t MAX_PACKET_SIZE = 0xFFFF;

static PyObject* CodecError;

// Core frame construction shared by encode_frame and encode_packets.
// The size cap applies to the uncompressed payload (matching the Python
// codec and the reference's pre-compression packet cap) so that the
// decoder's decompression cap never rejects an honestly-encoded frame.
static PyObject* build_frame(const char* payload, size_t payload_len,
                             int compression) {
  if (payload_len > MAX_PACKET_SIZE) {
    PyErr_Format(CodecError, "packet oversized: %zu", payload_len);
    return nullptr;
  }
  char* scratch = nullptr;
  if (compression == 1) {
    size_t max_len = snappy_max_compressed_length(payload_len);
    scratch = static_cast<char*>(PyMem_Malloc(max_len));
    if (!scratch) return PyErr_NoMemory();
    size_t compressed_len = max_len;
    if (snappy_compress(payload, payload_len, scratch, &compressed_len) == 0 &&
        compressed_len < payload_len) {
      payload = scratch;
      payload_len = compressed_len;
    } else {
      // Incompressible (or error): store raw, mirroring the Python codec.
      compression = 0;
    }
  }

  if (payload_len > MAX_PACKET_SIZE) {
    if (scratch) PyMem_Free(scratch);
    PyErr_Format(CodecError, "packet oversized: %zu", payload_len);
    return nullptr;
  }

  PyObject* out = PyBytes_FromStringAndSize(nullptr,
                                            (Py_ssize_t)(HEADER_SIZE + payload_len));
  if (out) {
    unsigned char* dst =
        reinterpret_cast<unsigned char*>(PyBytes_AS_STRING(out));
    dst[0] = MAGIC0;
    dst[1] = MAGIC1;
    dst[2] = (unsigned char)((payload_len >> 8) & 0xFF);
    dst[3] = (unsigned char)(payload_len & 0xFF);
    dst[4] = (unsigned char)compression;
    memcpy(dst + HEADER_SIZE, payload, payload_len);
  }
  if (scratch) PyMem_Free(scratch);
  return out;
}

// encode_frame(body: bytes, compression: int = 0) -> bytes
static PyObject* codec_encode_frame(PyObject* self, PyObject* args) {
  Py_buffer body;
  int compression = 0;
  if (!PyArg_ParseTuple(args, "y*|i", &body, &compression)) return nullptr;
  PyObject* out = build_frame(static_cast<const char*>(body.buf),
                              (size_t)body.len, compression);
  PyBuffer_Release(&body);
  return out;
}

// decode_frames(buf: bytes-like) -> (list[tuple[bytes, int]], consumed: int)
//
// Parses every complete frame in buf, decompressing snappy bodies.
// Raises CodecError on a bad magic or zero-size frame (connection-fatal).
static PyObject* codec_decode_frames(PyObject* self, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;

  const unsigned char* data = static_cast<const unsigned char*>(buf.buf);
  size_t len = static_cast<size_t>(buf.len);
  size_t pos = 0;

  PyObject* frames = PyList_New(0);
  if (!frames) {
    PyBuffer_Release(&buf);
    return nullptr;
  }

  while (len - pos >= HEADER_SIZE) {
    const unsigned char* tag = data + pos;
    if (tag[0] != MAGIC0 || tag[1] != MAGIC1) {
      Py_DECREF(frames);
      PyBuffer_Release(&buf);
      PyErr_Format(CodecError, "invalid tag at offset %zu", pos);
      return nullptr;
    }
    size_t size = ((size_t)tag[2] << 8) | (size_t)tag[3];
    if (size == 0) {
      Py_DECREF(frames);
      PyBuffer_Release(&buf);
      PyErr_SetString(CodecError, "zero-size frame");
      return nullptr;
    }
    if (len - pos < HEADER_SIZE + size) break;  // incomplete frame
    int ct = tag[4];
    const char* body = reinterpret_cast<const char*>(tag + HEADER_SIZE);

    PyObject* payload = nullptr;
    if (ct == 1) {
      size_t out_len = 0;
      if (snappy_uncompressed_length(body, size, &out_len) != 0) {
        Py_DECREF(frames);
        PyBuffer_Release(&buf);
        PyErr_SetString(CodecError, "corrupt snappy length preamble");
        return nullptr;
      }
      // Frame bodies are capped at MAX_PACKET_SIZE pre-compression, so a
      // preamble claiming more than a small multiple of that is hostile;
      // allocating it would be a pre-auth memory amplification.
      if (out_len > 4 * MAX_PACKET_SIZE) {
        Py_DECREF(frames);
        PyBuffer_Release(&buf);
        PyErr_Format(CodecError, "snappy uncompressed length %zu exceeds cap",
                     out_len);
        return nullptr;
      }
      payload = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)out_len);
      if (payload &&
          snappy_uncompress(body, size, PyBytes_AS_STRING(payload), &out_len) != 0) {
        Py_DECREF(payload);
        Py_DECREF(frames);
        PyBuffer_Release(&buf);
        PyErr_SetString(CodecError, "corrupt snappy data");
        return nullptr;
      }
    } else {
      payload = PyBytes_FromStringAndSize(body, (Py_ssize_t)size);
    }
    if (!payload) {
      Py_DECREF(frames);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    PyObject* item = Py_BuildValue("(Ni)", payload, ct);
    if (!item || PyList_Append(frames, item) < 0) {
      Py_XDECREF(item);
      Py_DECREF(frames);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    Py_DECREF(item);
    pos += HEADER_SIZE + size;
  }

  PyBuffer_Release(&buf);
  return Py_BuildValue("(Nn)", frames, (Py_ssize_t)pos);
}

// ---- outbound packet building -------------------------------------------
//
// Hand-rolled protobuf wire encoding of chtpu.Packet:
//   Packet.messages    = field 1, length-delimited (tag 0x0A)
//   MessagePack fields = channelId(1)/broadcast(2)/stubId(3)/msgType(4)
//                        varint, msgBody(5) bytes; proto3 zero-omission.
// Byte-identical to the generated serializer (verified in tests).

static size_t varint_size(uint64_t v) {
  size_t n = 1;
  while (v >= 0x80) {
    v >>= 7;
    n++;
  }
  return n;
}

static void write_varint(std::string& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back((char)((v & 0x7F) | 0x80));
    v >>= 7;
  }
  out.push_back((char)v);
}

// encode_packets(msgs, compression) -> (list[bytes], list[int])
//
// msgs: sequence of (channelId, broadcast, stubId, msgType, msgBody).
// Batches message packs into framed packets, each body <= 64KB before
// compression (mirroring Connection.flush's batching + oversize skip);
// returns the ready-to-write frames plus the number of messages packed
// into each frame (for exact sent-metrics attribution).
static PyObject* codec_encode_packets(PyObject* self, PyObject* args) {
  PyObject* seq;
  int compression = 0;
  if (!PyArg_ParseTuple(args, "O|i", &seq, &compression)) return nullptr;
  PyObject* fast = PySequence_Fast(seq, "encode_packets expects a sequence");
  if (!fast) return nullptr;

  Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
  PyObject* frames = PyList_New(0);
  if (!frames) {
    Py_DECREF(fast);
    return nullptr;
  }

  PyObject* counts = PyList_New(0);
  if (!counts) {
    Py_DECREF(fast);
    Py_DECREF(frames);
    return nullptr;
  }

  std::string body;
  body.reserve(MAX_PACKET_SIZE + 64);
  long body_msgs = 0;

  auto flush_body = [&](void) -> bool {
    if (body.empty()) return true;
    PyObject* frame = build_frame(body.data(), body.size(), compression);
    if (!frame) return false;
    int rc = PyList_Append(frames, frame);
    Py_DECREF(frame);
    if (rc != 0) return false;
    PyObject* cnt = PyLong_FromLong(body_msgs);
    if (!cnt) return false;
    rc = PyList_Append(counts, cnt);
    Py_DECREF(cnt);
    body.clear();
    body_msgs = 0;
    return rc == 0;
  };

  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(fast, i);
    unsigned long ch, bc, stub, mt;
    Py_buffer mb;
    if (!PyArg_ParseTuple(item, "kkkky*", &ch, &bc, &stub, &mt, &mb)) {
      Py_DECREF(fast);
      Py_DECREF(frames);
      Py_DECREF(counts);
      return nullptr;
    }
    // MessagePack submessage payload size.
    size_t pack_size = 0;
    if (ch) pack_size += 1 + varint_size(ch);
    if (bc) pack_size += 1 + varint_size(bc);
    if (stub) pack_size += 1 + varint_size(stub);
    if (mt) pack_size += 1 + varint_size(mt);
    if (mb.len) pack_size += 1 + varint_size((uint64_t)mb.len) + (size_t)mb.len;
    size_t entry_size = 1 + varint_size(pack_size) + pack_size;

    if (entry_size > MAX_PACKET_SIZE) {
      PyBuffer_Release(&mb);
      continue;  // oversized single message: skip (caller logs)
    }
    if (body.size() + entry_size > MAX_PACKET_SIZE) {
      if (!flush_body()) {
        PyBuffer_Release(&mb);
        Py_DECREF(fast);
        Py_DECREF(frames);
        Py_DECREF(counts);
        return nullptr;
      }
    }
    body.push_back((char)0x0A);  // Packet.messages tag
    write_varint(body, pack_size);
    if (ch) {
      body.push_back((char)0x08);
      write_varint(body, ch);
    }
    if (bc) {
      body.push_back((char)0x10);
      write_varint(body, bc);
    }
    if (stub) {
      body.push_back((char)0x18);
      write_varint(body, stub);
    }
    if (mt) {
      body.push_back((char)0x20);
      write_varint(body, mt);
    }
    if (mb.len) {
      body.push_back((char)0x2A);
      write_varint(body, (uint64_t)mb.len);
      body.append(static_cast<const char*>(mb.buf), (size_t)mb.len);
    }
    body_msgs++;
    PyBuffer_Release(&mb);
  }
  Py_DECREF(fast);
  if (!flush_body()) {
    Py_DECREF(frames);
    Py_DECREF(counts);
    return nullptr;
  }
  return Py_BuildValue("(NN)", frames, counts);
}

// ---- inbound forward fast path ------------------------------------------
//
// parse_forward(body, conn_id, expect_channel, min_user_type)
//   -> None | (entries, counts)
//
// Scans one serialized chtpu.Packet. When EVERY message in it is a plain
// user-space forward (msgType >= min_user_type, broadcast == 0,
// stubId == 0, channelId == expect_channel, payload small enough to
// re-pack), returns the owner-bound send-queue entries with the
// ServerForwardMessage{clientConnId, payload} wrapper already encoded:
//   entries: list[(channelId, 0, 0, msgType, sfm_bytes)]
//   counts:  dict[msgType, n]   (for metrics attribution)
// Any other content — system messages, unknown fields, malformed wire
// data — returns None and the caller takes the full protobuf path. This
// removes the per-message Packet/MessagePack/ServerForwardMessage
// object churn from the gateway's steady-state ingest
// (ref: the reference parses in Go and forwards via the channel
// goroutine, connection.go:547-615 + message.go:66-126; this is the
// same routing decision made in native code).

static bool read_varint(const uint8_t** pp, const uint8_t* end, uint64_t* out) {
  const uint8_t* p = *pp;
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *pp = p;
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

static PyObject* codec_parse_forward(PyObject* self, PyObject* args) {
  Py_buffer buf;
  unsigned long conn_id, expect_ch, min_user;
  if (!PyArg_ParseTuple(args, "y*kkk", &buf, &conn_id, &expect_ch, &min_user))
    return nullptr;

  const uint8_t* p = static_cast<const uint8_t*>(buf.buf);
  const uint8_t* end = p + buf.len;
  PyObject* entries = PyList_New(0);
  PyObject* counts = PyDict_New();
  if (!entries || !counts) {
    Py_XDECREF(entries);
    Py_XDECREF(counts);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  bool slow = false, fail = false;
  std::string sfm;

  while (p < end && !slow && !fail) {
    if (*p != 0x0A) {  // not Packet.messages: unknown top-level field
      slow = true;
      break;
    }
    p++;
    uint64_t mlen = 0;
    if (!read_varint(&p, end, &mlen) || mlen > (uint64_t)(end - p)) {
      slow = true;
      break;
    }
    const uint8_t* mend = p + mlen;
    uint64_t ch = 0, bc = 0, stub = 0, mt = 0, plen = 0;
    const uint8_t* payload = nullptr;
    while (p < mend) {
      uint8_t tag = *p++;
      bool ok = true;
      switch (tag) {
        case 0x08: ok = read_varint(&p, mend, &ch); break;
        case 0x10: ok = read_varint(&p, mend, &bc); break;
        case 0x18: ok = read_varint(&p, mend, &stub); break;
        case 0x20: ok = read_varint(&p, mend, &mt); break;
        case 0x2A:
          ok = read_varint(&p, mend, &plen) && plen <= (uint64_t)(mend - p);
          if (ok) {
            payload = p;
            p += plen;
          }
          break;
        default:
          ok = false;
      }
      if (!ok) {
        slow = true;
        break;
      }
    }
    if (slow) break;
    if ((ch | bc | stub | mt) >> 32) {
      // Over-long varints: protobuf truncates these uint32 fields to 32
      // bits (a crafted msgType of 2^32+5 IS system message 5 there) —
      // defer to the protobuf path so both classify identically.
      slow = true;
      break;
    }
    if (p != mend || mt < min_user || bc || stub || ch != expect_ch ||
        plen + 96 > MAX_PACKET_SIZE) {
      // Not a plain forward (or would oversize the outbound pack once
      // wrapped): let the full path handle the whole packet.
      slow = true;
      break;
    }
    sfm.clear();
    if (conn_id) {
      sfm.push_back((char)0x08);
      write_varint(sfm, conn_id);
    }
    if (plen) {
      sfm.push_back((char)0x12);
      write_varint(sfm, plen);
      sfm.append(reinterpret_cast<const char*>(payload), (size_t)plen);
    }
    PyObject* entry = Py_BuildValue("(kkkky#)", expect_ch, 0UL, 0UL,
                                    (unsigned long)mt, sfm.data(),
                                    (Py_ssize_t)sfm.size());
    if (!entry || PyList_Append(entries, entry) < 0) {
      Py_XDECREF(entry);
      fail = true;
      break;
    }
    Py_DECREF(entry);
    PyObject* key = PyLong_FromUnsignedLong((unsigned long)mt);
    if (!key) {
      fail = true;
      break;
    }
    PyObject* prev = PyDict_GetItem(counts, key);  // borrowed
    PyObject* next = PyLong_FromLong(prev ? PyLong_AsLong(prev) + 1 : 1);
    if (!next || PyDict_SetItem(counts, key, next) < 0) {
      Py_DECREF(key);
      Py_XDECREF(next);
      fail = true;
      break;
    }
    Py_DECREF(key);
    Py_DECREF(next);
  }

  PyBuffer_Release(&buf);
  if (fail) {
    Py_DECREF(entries);
    Py_DECREF(counts);
    return nullptr;
  }
  if (slow) {
    Py_DECREF(entries);
    Py_DECREF(counts);
    Py_RETURN_NONE;
  }
  return Py_BuildValue("(NN)", entries, counts);
}

// compress(data: bytes) -> bytes ; uncompress(data: bytes) -> bytes
static PyObject* codec_compress(PyObject* self, PyObject* args) {
  Py_buffer in;
  if (!PyArg_ParseTuple(args, "y*", &in)) return nullptr;
  size_t max_len = snappy_max_compressed_length((size_t)in.len);
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)max_len);
  if (!out) {
    PyBuffer_Release(&in);
    return nullptr;
  }
  size_t out_len = max_len;
  int status = snappy_compress(static_cast<const char*>(in.buf), (size_t)in.len,
                               PyBytes_AS_STRING(out), &out_len);
  PyBuffer_Release(&in);
  if (status != 0) {
    Py_DECREF(out);
    PyErr_Format(CodecError, "snappy_compress failed: %d", status);
    return nullptr;
  }
  if (_PyBytes_Resize(&out, (Py_ssize_t)out_len) < 0) return nullptr;
  return out;
}

static PyObject* codec_uncompress(PyObject* self, PyObject* args) {
  Py_buffer in;
  if (!PyArg_ParseTuple(args, "y*", &in)) return nullptr;
  size_t out_len = 0;
  if (snappy_uncompressed_length(static_cast<const char*>(in.buf), (size_t)in.len,
                                 &out_len) != 0) {
    PyBuffer_Release(&in);
    PyErr_SetString(CodecError, "corrupt snappy length preamble");
    return nullptr;
  }
  if (out_len > 4 * MAX_PACKET_SIZE) {
    PyBuffer_Release(&in);
    PyErr_Format(CodecError, "snappy uncompressed length %zu exceeds cap",
                 out_len);
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)out_len);
  if (!out) {
    PyBuffer_Release(&in);
    return nullptr;
  }
  int status = snappy_uncompress(static_cast<const char*>(in.buf), (size_t)in.len,
                                 PyBytes_AS_STRING(out), &out_len);
  PyBuffer_Release(&in);
  if (status != 0) {
    Py_DECREF(out);
    PyErr_SetString(CodecError, "corrupt snappy data");
    return nullptr;
  }
  return out;
}

static PyMethodDef codec_methods[] = {
    {"encode_frame", codec_encode_frame, METH_VARARGS,
     "encode_frame(body, compression=0) -> framed bytes"},
    {"decode_frames", codec_decode_frames, METH_VARARGS,
     "decode_frames(buf) -> ([(body, compression)], consumed)"},
    {"encode_packets", codec_encode_packets, METH_VARARGS,
     "encode_packets([(chId, bc, stub, mt, body)], compression) -> ([frames], [counts])"},
    {"parse_forward", codec_parse_forward, METH_VARARGS,
     "parse_forward(body, conn_id, expect_channel, min_user_type) -> "
     "None | (entries, counts)"},
    {"compress", codec_compress, METH_VARARGS, "snappy compress"},
    {"uncompress", codec_uncompress, METH_VARARGS, "snappy uncompress"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef codec_module = {
    PyModuleDef_HEAD_INIT, "_codec",
    "Native wire codec (framing + snappy) for channeld-tpu.", -1,
    codec_methods,
};

PyMODINIT_FUNC PyInit__codec(void) {
  PyObject* m = PyModule_Create(&codec_module);
  if (!m) return nullptr;
  CodecError = PyErr_NewException("channeld_tpu.native._codec.CodecError",
                                  PyExc_ValueError, nullptr);
  Py_INCREF(CodecError);
  if (PyModule_AddObject(m, "CodecError", CodecError) < 0) {
    Py_DECREF(CodecError);
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
