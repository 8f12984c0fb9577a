// The position updates of a serialized StepRequest as two columns.
//
// Walks the wire bytes of a chtpu.ops.StepRequest (ops/service.proto) and
// fills, from its field 1 (repeated EntityPosition updates) only, ids[k]
// (entityId) and xyz[k][3] (x, y, z), in the order the updates appear.
// The rules are protobuf's, as the Python runtime's parser applies them:
// fields in any order; an absent field reads 0; a field of an unknown number
// or of another wire type than its declaration's is skipped (groups too); a
// scalar that repeats inside one submessage takes its last value; varints
// of up to 10 bytes, an entityId truncated to its low 32 bits. The float
// bits are copied as they are (-0.0 and NaN payloads included), except that a
// signalling NaN gets its quiet bit: Python reads a float field as a double,
// which quiets it, so that is what a position read field by field holds.
// Little-endian hosts only, as the wire is.
//
// Plain C ABI for ctypes (native/__init__.py: load_step_columns); no Python
// headers and no library beyond libc.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxGroupDepth = 100;

struct Reader {
    const uint8_t* p;
    const uint8_t* end;

    bool varint(uint64_t& out) {
        uint64_t v = 0;
        for (int i = 0; i < 10; ++i) {
            if (p >= end) return false;
            uint8_t b = *p++;
            v |= uint64_t(b & 0x7f) << (7 * i);
            if (!(b & 0x80)) {
                out = v;
                return true;
            }
        }
        return false;
    }

    bool tag(uint32_t& field, uint32_t& wire) {
        uint64_t t;
        if (!varint(t) || t > 0xffffffffu) return false;
        field = uint32_t(t >> 3);
        wire = uint32_t(t & 7);
        return field != 0;
    }

    bool skip(uint64_t n) {
        if (uint64_t(end - p) < n) return false;
        p += n;
        return true;
    }

    // Skips the value of a field whose tag was just read. A group is
    // skipped to its matching end tag.
    bool skip_field(uint32_t field, uint32_t wire, int depth = 0) {
        uint64_t v;
        switch (wire) {
            case 0: return varint(v);
            case 1: return skip(8);
            case 2: return varint(v) && skip(v);
            case 5: return skip(4);
            case 3: {
                if (depth >= kMaxGroupDepth) return false;
                for (;;) {
                    uint32_t f, w;
                    if (!tag(f, w)) return false;
                    if (w == 4) return f == field;
                    if (!skip_field(f, w, depth + 1)) return false;
                }
            }
            default: return false;  // 4: an end tag with no group open; 6, 7
        }
    }
};

// One EntityPosition in [p, end) into id and the three float bit patterns.
bool entity_position(Reader r, uint32_t& id, uint32_t bits[3]) {
    id = 0;
    bits[0] = bits[1] = bits[2] = 0;
    while (r.p < r.end) {
        uint32_t field, wire;
        if (!r.tag(field, wire)) return false;
        if (field == 1 && wire == 0) {
            uint64_t v;
            if (!r.varint(v)) return false;
            id = uint32_t(v);
        } else if (field >= 2 && field <= 4 && wire == 5) {
            if (r.end - r.p < 4) return false;
            uint32_t b;
            std::memcpy(&b, r.p, 4);
            r.p += 4;
            if ((b & 0x7f800000u) == 0x7f800000u && (b & 0x007fffffu)) b |= 0x00400000u;
            bits[field - 2] = b;
        } else if (!r.skip_field(field, wire)) {
            return false;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Decodes buf[0:len) into ids[0:k] and xyz[0:3k]; returns k, -1 when the
// bytes are not a well-formed message, -2 when it holds more than cap
// updates (the columns are then filled up to cap).
int64_t chtpu_step_columns(const uint8_t* buf, uint64_t len, uint32_t* ids, float* xyz,
                           int64_t cap) {
    Reader r{buf, buf + len};
    int64_t k = 0;
    while (r.p < r.end) {
        uint32_t field, wire;
        if (!r.tag(field, wire)) return -1;
        if (field == 1 && wire == 2) {
            uint64_t n;
            if (!r.varint(n) || uint64_t(r.end - r.p) < n) return -1;
            Reader sub{r.p, r.p + n};
            r.p += n;
            if (k >= cap) return -2;
            uint32_t bits[3];
            if (!entity_position(sub, ids[k], bits)) return -1;
            std::memcpy(xyz + 3 * k, bits, sizeof bits);
            ++k;
        } else if (!r.skip_field(field, wire)) {
            return -1;
        }
    }
    return k;
}

}  // extern "C"
